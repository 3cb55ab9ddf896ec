// Backward of the SSD (Mamba2) within-chunk kernel for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package differentiates its plain
// `ssd_chunked` (src/repro/models/ssm.py:70) with XLA's autodiff; this is
// the port's counterpart of that autodiff for the SSD chunk kernel
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
// dB and dC of a group sum over its heads.  fp32 in and out.
//
// What bounds it on an H100: operations.  Per chunk it forms the Q x Q
// products C.B^T (per group) and dy.x^T (per head), three more of the
// same size (dx per head; dB and dC), and the state's dS B and dS^T x per
// head, against x, dt, B, C, dy, dS read and dx, ddt, dB, dC written
// once: at Q = 256 that is ~80 operations a byte, far above the fp32 CUDA
// cores' line.  So every product runs on the tensor cores in 3xTF32, as
// the forward does (tf32_mma.cuh; one TF32 pass would miss the 1e-4 row
// limit by 4-12x), each k-step's three mma.sync into a fresh fragment
// that an fp32 add folds into the running sum (see warp_mma), and the
// design forms each product once.  A CTA of launches 1 and 2 owns (batch
// x chunk, block of HB heads of a group, 64-row tile s):
//   - launch 1, the state's terms (N > 32 only): per head dS_h B_s (dx_s
//     starts at w_s dS_h B_s; dw_s), and (w x_s) dS over the block's heads
//     and P at once (one product of depth HB P: the block's share of dB).
//     Where N <= 32 these are a few short products a head, and the tile
//     CTAs take them in one more step a head (a launch of their own would
//     cost its latency, not its work).
//   - launch 2, the tiles: it walks the row tiles r >= s (the grid puts
//     the heaviest column tiles first).  For each it forms C_r . B_s^T
//     once for the block (in registers), then per head dy_r . x_s^T, the
//     elementwise L, W, dCB and R in fp32 registers, and dx_s += W^T dy_r
//     (W^T through shared memory); dCB is summed over the block's heads
//     in head order and written out as one 64 x 64 tile a (block, tile
//     pair).  Row sums of R over the tile (rowR) go out as one partial a
//     column tile; column sums (K, colR) stay in the CTA.  HB = 256 / P
//     heads (at most 8) keeps the block's dx fragments (HB P / 4 a
//     thread) in registers; where N <= 32, C.B^T is cheap and HB halves
//     so that two CTAs share an SM.
//   - launch 3: one CTA a head for ddt and dA (the suffix sum of dcs, one
//     warp a batch x chunk, rowR's partials and dA summed in a fixed
//     order), beside one CTA a (batch x chunk, group, 16 rows of a 64-row
//     tile, 64 columns of N) for dC_r = sum_s T_rs B_s or dB_s = sum_r
//     T_rs^T C_r + the state's part, with T the dCB tiles summed over the
//     group's blocks in block order first: dB and dC are multiplied once
//     a group, not once a head.
// Tiles move by 16-byte `cp.async` (4-byte copies where a row is not
// 16-byte aligned) into a ring of two slots; rows read along k are 4 mod
// 32 floats long, rows read across k 8 mod 32, so the fragment loads hit
// distinct banks.  N = 16 runs two k-steps of 8, unpadded.
// Every output is written from one place, in a fixed order, with no
// atomics: the same inputs give the same bits.  A sum over t >= s is taken
// over exactly those terms (masked products are exact zeros in the
// fragments), never as a total less a prefix, so row s of dx, ddt, dB and
// dC (and row t of dC) does not move with dy in rows before it.  A ragged
// Q (any length <= 1024) is masked here: rows >= Q are staged as zeros
// and never written.
#include "tf32_mma.cuh"

namespace repro_torch {
namespace {

constexpr int kT = 64;          // rows and columns of a tile
constexpr int kThreads = 256;   // 8 warps: 4 row warps x 2 column warps
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 32;         // depth of a staged chunk
constexpr int kLdK = kKC + 4;   // chunk row read along k (4 mod 32)
constexpr int kLdW = kT + 4;    // 64-wide tile read along k (4 mod 32)
constexpr int kLdN = kT + 8;    // 64-wide rows read across k (8 mod 32)
constexpr int kSlots = 2;       // ring slots: 1 step in flight
constexpr int kMaxN = 256;
constexpr int kMaxQ = 1024;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// heads a block (at most; halved where N <= 32, see launch): a launch-2
// CTA's dx fragments take HB P / 4 registers a thread
__host__ __device__ constexpr int heads_per_block(int P) {
  return P >= 32 ? 256 / P : 8;
}

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One warp: acc += A . B over `ksteps` (<= KMAX) k-steps of 8, for the
// warp's 16 rows and NT 8-column tiles (those past n_live skipped).
// A(m, k) = A[m * lda + k]; B(k, n) = BT ? B[n * ldb + k] : B[k * ldb + n].
// Each k-step's three mma.sync go into a fresh fragment that an fp32 add
// folds into acc: the tensor cores truncate as they accumulate, and a
// longer chain costs 3-5x the precision, which rows that cancel across
// heads (dC of a position whose dCB nearly sums to zero) cannot spare.
// Element e of acc[j] is row gq + 8 (e >> 1), column 8 j + 2 tq + (e & 1),
// for lane = 4 gq + tq.
template <int NT, bool BT, int KMAX>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], const float* A,
                                         int lda, const float* B, int ldb,
                                         int ksteps, int n_live) {
  const int lane = threadIdx.x & 31;
  const int gq = lane >> 2;
  const int tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KMAX; ++kk) {
    if (kk >= ksteps) break;
    const float* ap = A + gq * lda + kk * 8 + tq;
    const float v[4] = {ap[0], ap[8 * lda], ap[4], ap[8 * lda + 4]};
    const FragA a(v);
    float part[NT][4] = {};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= n_live) continue;
      if (BT) {
        const float* bp = B + (j * 8 + gq) * ldb + kk * 8 + tq;
        mma_3xtf32(part[j], a, bp[0], bp[4]);
      } else {
        const float* bp = B + (kk * 8 + tq) * ldb + j * 8 + gq;
        mma_3xtf32(part[j], a, bp[0], bp[4 * ldb]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

struct Args {
  const float *x, *dt, *A, *Bm, *Cm, *dy, *dS;
  float *dx, *ddt, *dA, *dB, *dC;
  // workspace: T [BNc, G n_hb, n_pairs, 64, 64] (dCB summed over a block's
  // heads), dBs [BNc, G n_hb, Q, N] (the state's dB, summed likewise),
  // rowR [BNc, H, n_rt, Q] (row sums of R over one column tile), colR, K
  // and dw [BNc, H, Q]
  float *T, *dBs, *rowR, *colR, *K, *dw;
  int* counts;  // null, or int32 [1]: the tile launch adds one per call
};

struct Shapes {
  int Q, H, G, N, Qpad, n_rt, n_pairs, n_hb;  // n_hb: head blocks a group
  int64_t BNc, x_row, b_row;  // row strides of [.., Q, H, P], [.., Q, G, N]
  bool vec_x, vec_dy, vec_bc, vec_ds;
};

__device__ __forceinline__ int64_t pair_index(int r, int s) {
  return static_cast<int64_t>(r) * (r + 1) / 2 + s;
}

// A CTA's share of the grid of launches 1 and 2: (batch x chunk bc, head
// block blk of group g, 64-row tile st), its heads [h0, h0 + nh) (the
// group's heads dealt out evenly over its blocks) and their cs and dt over
// the chunk in shared memory.
struct Block {
  int64_t bc, blkg;  // blkg: the block's index among all BNc G n_hb
  int g, h0, nh, st, s0;
};

__device__ __forceinline__ Block block_at(const Shapes& sh, int64_t i) {
  const int64_t per_tile = sh.BNc * sh.G * sh.n_hb;
  Block b;
  b.st = static_cast<int>(i / per_tile);
  i %= per_tile;
  const int blk = static_cast<int>(i % sh.n_hb);
  i /= sh.n_hb;
  b.g = static_cast<int>(i % sh.G);
  b.bc = i / sh.G;
  b.blkg = (b.bc * sh.G + b.g) * sh.n_hb + blk;
  const int Hg = sh.H / sh.G;
  const int q0 = blk * Hg / sh.n_hb;
  b.nh = (blk + 1) * Hg / sh.n_hb - q0;
  b.h0 = b.g * Hg + q0;
  b.s0 = b.st * kT;
  return b;
}

// All threads: dt of the block's heads into dts[u * Qpad + s] by 4-byte
// copies, one committed group; then (after the caller's wait and barrier)
// scan_cs: warp u scans head u into cs.
__device__ __forceinline__ void gather_dt(const Args& a, const Shapes& sh,
                                          const Block& b, float* dts) {
  const float* dtb = a.dt + b.bc * sh.Q * sh.H + b.h0;
  for (int i = threadIdx.x; i < b.nh * sh.Q; i += kThreads) {
    const int u = i / sh.Q;
    const int s = i - u * sh.Q;
    cp_async4(dts + u * sh.Qpad + s,
              dtb + static_cast<int64_t>(s) * sh.H + u, true);
  }
  cp_async_commit();
}

__device__ __forceinline__ void scan_cs(const Args& a, const Shapes& sh,
                                        const Block& b, float* cs,
                                        float* dts) {
  const int warp = threadIdx.x >> 5;
  if (warp < b.nh)
    scan_head(__ldg(a.A + b.h0 + warp), sh.Q, sh.Qpad, cs + warp * sh.Qpad,
              dts + warp * sh.Qpad, threadIdx.x & 31);
}

// All threads: wS[u * 64 + c] = w_s = exp(cs_{Q-1} - cs_s) dt_s of the
// block's head u at s = s0 + c (zero past Q and the block's heads)
template <int HB>
__device__ __forceinline__ void fill_w(const float* cs, const float* dts,
                                       int nh, int s0, int Q, int Qpad,
                                       float* wS) {
  for (int i = threadIdx.x; i < HB * kT; i += kThreads) {
    const int u = i / kT;
    const int s = s0 + i - u * kT;
    wS[i] = u < nh && s < Q
                ? exp_fast(cs[u * Qpad + Q - 1] - cs[u * Qpad + s]) *
                      dts[u * Qpad + s]
                : 0.f;
  }
}

// dw_s = x_s . (dS B_s) over this warp's P / 2 columns, for rows ra and
// ra + 8 of the tile (x rows LDX floats apart), summed over the rows'
// four lanes into red[wn][row]; the caller adds the two column warps
template <int P, int NT>
__device__ __forceinline__ void dw_rows(const float* X, int ldx,
                                        const float (&dsb)[NT][4], int ra,
                                        int wn, float* red) {
  const int tq = threadIdx.x & 3;
  float pa = 0.f, pb = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int p = wn * (P / 2) + j * 8 + 2 * tq;
    pa += X[ra * ldx + p] * dsb[j][0] + X[ra * ldx + p + 1] * dsb[j][1];
    pb += X[(ra + 8) * ldx + p] * dsb[j][2] +
          X[(ra + 8) * ldx + p + 1] * dsb[j][3];
  }
  pa += __shfl_xor_sync(0xffffffffu, pa, 1);
  pa += __shfl_xor_sync(0xffffffffu, pa, 2);
  pb += __shfl_xor_sync(0xffffffffu, pb, 1);
  pb += __shfl_xor_sync(0xffffffffu, pb, 2);
  if (tq == 0) {
    red[wn * kT + ra] = pa;
    red[wn * kT + ra + 8] = pb;
  }
}

// ---- launch 1: the state's terms ----------------------------------------

// a ring slot of launch 1: a B chunk and a dS chunk, x rows, or an x chunk
// and a dS chunk
template <int P>
__host__ __device__ constexpr int state_slot() {
  return imax(imax((kT + P) * kLdK, kT * (P + 4)),
              kT * kLdK + kKC * kLdN);
}

template <int P, int HB>
size_t state_smem_floats(int Qpad) {
  return 2 * static_cast<size_t>(HB) * Qpad + HB * kT + 2 * kT +
         kSlots * state_slot<P>();
}

// Two kinds of CTA, each on a block of heads and a 64-row tile st of
// positions s (see Block):
//   - a head CTA: for each head u the 32-column chunks of N of dS_u B_s,
//     then x_s of u: dx_s = w_s (dS_u B_s) (launch 2 adds the rest) and
//     dw_s = x_s . (dS_u B_s);
//   - a dB CTA (and 64 columns nc of N): the 32-deep chunks of (w x_s) dS
//     over the block's heads x P at once, the state's dB summed over the
//     block's heads.
// Launched where N > 32 only: below, the tile CTAs take these terms (see
// ssd_bwd_tiles_kernel).
template <int P, int HB>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_state_kernel(Args a, Shapes sh) {
  extern __shared__ __align__(16) float sm[];
  constexpr int NT = P / 16;  // 8-column tiles of a warp's P / 2 columns
  constexpr int LDX = P + 4;
  constexpr int SLOT = state_slot<P>();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int wm = warp & 3;   // rows 16 wm ..
  const int wn = warp >> 2;  // columns 32 wn .. or P / 2 wn ..
  const int Q = sh.Q, N = sh.N, Qpad = sh.Qpad;
  const int n_nc = (N + kT - 1) / kT;
  const int64_t heads = sh.BNc * sh.G * sh.n_hb * sh.n_rt;  // head CTAs
  int64_t i = blockIdx.x;
  const bool head = i < heads;
  int n0 = 0;
  if (!head) {
    i -= heads;
    n0 = static_cast<int>(i % n_nc) * kT;
    i /= n_nc;
  }
  const Block b = block_at(sh, i);
  const int s0 = b.s0;
  float* cs = sm;                   // [HB][Qpad]
  float* dts = cs + HB * Qpad;      // [HB][Qpad]
  float* wS = dts + HB * Qpad;      // [HB][64]: w_s of the tile
  float* red = wS + HB * kT;        // [2][64]: row sums by column warp
  float* ring = red + 2 * kT;       // kSlots x SLOT
  gather_dt(a, sh, b, dts);

  const float* Bs = a.Bm + (b.bc * Q + s0) * sh.b_row +
                    static_cast<int64_t>(b.g) * N;
  const float* xs = a.x + (b.bc * Q + s0) * sh.x_row +
                    static_cast<int64_t>(b.h0) * P;
  const float* dSb = a.dS + (b.bc * sh.H + b.h0) * static_cast<int64_t>(P) * N;
  const int nkc = (N + kKC - 1) / kKC;
  const int depth = b.nh * P;
  const int nkb = (depth + kKC - 1) / kKC;
  const int steps = head ? b.nh * (nkc + 1) : nkb;
  const int cols = min(kT, (N - n0 + 7) / 8 * 8);  // a block CTA's columns
  auto stage = [&](int k, int slot) {
    float* dst = ring + slot * SLOT;
    const int u = head ? k / (nkc + 1) : 0;
    if (head) k -= u * (nkc + 1);
    if (head && k < nkc) {  // B_s and dS_u, columns [32 k, 32 k + 32) of N
      const int kc = k * kKC;
      stage_tile<kThreads>(dst, kLdK, Bs + kc, sh.b_row, kT, Q - s0, kKC,
                           N - kc, sh.vec_bc, tid);
      stage_tile<kThreads>(dst + kT * kLdK, kLdK,
                           dSb + static_cast<int64_t>(u) * P * N + kc, N, P,
                           P, kKC, N - kc, sh.vec_ds, tid);
    } else if (head) {  // x_s of u
      stage_tile<kThreads>(dst, LDX, xs + u * P, sh.x_row, kT, Q - s0, P, P,
                           sh.vec_x, tid);
    } else {  // x_s and dS over (head, p) [32 k, ..), N [n0, n0 + 64)
      const int kb0 = k * kKC;
      stage_tile<kThreads>(dst, kLdK, xs + kb0, sh.x_row, kT, Q - s0, kKC,
                           depth - kb0, sh.vec_x, tid);
      stage_tile<kThreads>(dst + kT * kLdK, kLdN,
                           dSb + static_cast<int64_t>(kb0) * N + n0, N, kKC,
                           depth - kb0, kT, N - n0, sh.vec_ds, tid);
    }
  };

  prefetch<kSlots>(steps, stage);
  cp_async_wait<kSlots - 1>();  // dt has landed
  __syncthreads();
  scan_cs(a, sh, b, cs, dts);
  __syncthreads();
  fill_w<HB>(cs, dts, b.nh, s0, Q, Qpad, wS);
  // (run's first barrier publishes wS)

  float dsb[NT][4];  // a head CTA's dS_h B_s: rows 16 wm, P / 2 columns
  float dbs[4][4];   // a block CTA's share of the state's dB
  zero(dsb);
  zero(dbs);
  const int ra = wm * 16 + gq;  // this thread's rows: ra, ra + 8
  run<kSlots>(steps, stage, [&](int k, int slot) {
    float* X = ring + slot * SLOT;
    const int u = head ? k / (nkc + 1) : 0;
    if (head) k -= u * (nkc + 1);
    if (head && k < nkc) {
      if (k == 0) zero(dsb);
      warp_mma<NT, true, kKC / 8>(dsb, X + wm * 16 * kLdK, kLdK,
                                  X + (kT + wn * (P / 2)) * kLdK, kLdK,
                                  (min(kKC, N - k * kKC) + 7) / 8, NT);
      return;
    }
    if (head) {  // dw_s = x_s . (dS_u B_s); dx_s = w_s (dS_u B_s)
      const int h = b.h0 + u;
      const float wa = wS[u * kT + ra];
      const float wb = wS[u * kT + ra + 8];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + ra + 8 * (e >> 1);
          if (s < Q)
            a.dx[(b.bc * Q + s) * sh.x_row + static_cast<int64_t>(h) * P +
                 wn * (P / 2) + j * 8 + 2 * tq + (e & 1)] =
                (e < 2 ? wa : wb) * dsb[j][e];
        }
      dw_rows<P>(X, LDX, dsb, ra, wn, red);
      __syncthreads();
      if (tid < kT && s0 + tid < Q)
        a.dw[(b.bc * sh.H + h) * static_cast<int64_t>(Q) + s0 + tid] =
            red[tid] + red[kT + tid];
      return;
    }
    // weight x_s by w_s of its head, in place
    for (int e = tid; e < kT * kKC; e += kThreads) {
      const int r = e / kKC;
      const int c = e - r * kKC;
      X[r * kLdK + c] *= wS[((k * kKC + c) / P) * kT + r];
    }
    __syncthreads();
    const int live = min(4, max(0, (cols - wn * 32) / 8));
    warp_mma<4, false, kKC / 8>(dbs, X + wm * 16 * kLdK, kLdK,
                                X + kT * kLdK + wn * 32, kLdN, kKC / 8, live);
    if (k == nkb - 1) {
      float* out = a.dBs + b.blkg * Q * static_cast<int64_t>(N);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = s0 + ra + 8 * (e >> 1);
          const int n = n0 + wn * 32 + j * 8 + 2 * tq + (e & 1);
          if (s < Q && n < N)
            out[static_cast<int64_t>(s) * N + n] = dbs[j][e];
        }
    }
  });
}

// ---- launch 2: the tiles ------------------------------------------------
// a ring slot of launch 2: a C and a B chunk, dy and x rows of a head, or
// (N <= 32) x rows, B_s and dS of a head
template <int P>
__host__ __device__ constexpr int tile_slot() {
  return imax(imax(2 * kT * kLdK, kT * (2 * P + 12)),
              kT * (P + 4) + (kT + P) * kLdK);
}

// cs and dt of the block's heads, w of the column tile, the K and colR
// sums by row warp, the row sums by column warp, the W^T tile and the ring
template <int P, int HB>
size_t tile_smem_floats(int Qpad) {
  return 2 * static_cast<size_t>(HB) * Qpad + HB * kT + 2 * HB * 4 * kT +
         2 * kT + kT * kLdW + kSlots * tile_slot<P>();
}

// One CTA (see Block; st the column tile).  Steps, each one ring slot: for
// each row tile r >= st the 32-column chunks of N of C_r . B_s^T, then for
// each head u dy_r and x_s of u.  Where N <= 32 (one chunk: the state's
// terms are a few short products a head, and a launch of their own would
// be latency, not work) one more step a head comes first and takes launch
// 1's terms here: from x_s, B_s and dS_u, dx starts at w_s (dS_u B_s),
// dw_s = x_s . (dS_u B_s), and w_s (x_s dS_u) summed over the block's
// heads is its share of the state's dB.
template <int P, int HB, bool SMALL>
__global__ void __launch_bounds__(kThreads, SMALL ? 2 : 1)
ssd_bwd_tiles_kernel(Args a, Shapes sh) {
  count_launch(a.counts, 0);
  extern __shared__ __align__(16) float sm[];
  constexpr int NT = P / 16;  // 8-column tiles of a warp's P / 2 columns
  constexpr int LDX = P + 4;  // x rows (read along k)
  constexpr int LDY = P + 8;  // dy rows (read across k by dx's product)
  constexpr int SLOT = tile_slot<P>();
  const Block b = block_at(sh, blockIdx.x);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int wm = warp & 3;   // rows 16 wm ..
  const int wn = warp >> 2;  // columns: 64-wide 32 wn .., P-wide P / 2 wn ..
  const int Q = sh.Q, N = sh.N, Qpad = sh.Qpad, H = sh.H;
  const int st = b.st, s0 = b.s0, nh = b.nh, h0 = b.h0;
  const int64_t bc = b.bc;

  float* cs = sm;                   // [HB][Qpad]
  float* dts = cs + HB * Qpad;      // [HB][Qpad]
  float* wS = dts + HB * Qpad;      // [HB][64]: w_s of the column tile
  float* Kacc = wS + HB * kT;       // [HB][4][64]: K by row warp
  float* Racc = Kacc + HB * 4 * kT; // [HB][4][64]: colR by row warp
  float* red = Racc + HB * 4 * kT;  // [2][64]: row sums by column warp
  float* Wt = red + 2 * kT;         // [64][kLdW]: W^T of one head
  float* ring = Wt + kT * kLdW;     // kSlots x SLOT
  gather_dt(a, sh, b, dts);
  for (int i = tid; i < 2 * HB * 4 * kT; i += kThreads) Kacc[i] = 0.f;

  const int64_t gn = static_cast<int64_t>(b.g) * N;
  const float* Bs = a.Bm + (bc * Q + s0) * sh.b_row + gn;
  const float* Cg = a.Cm + bc * Q * sh.b_row + gn;
  const float* xs = a.x + (bc * Q + s0) * sh.x_row +
                    static_cast<int64_t>(h0) * P;
  const float* dyb = a.dy + bc * Q * sh.x_row + static_cast<int64_t>(h0) * P;
  const int nkc = (N + kKC - 1) / kKC;
  const int per_r = nkc + nh;
  const int n_s = SMALL ? nh : 0;  // the state's terms: one step a head
  const int steps = n_s + (sh.n_rt - st) * per_r;

  auto stage = [&](int i, int slot) {
    float* dst = ring + slot * SLOT;
    if (SMALL && i < n_s) {  // x_s, B_s and dS of head i
      stage_tile<kThreads>(dst, LDX, xs + i * P, sh.x_row, kT, Q - s0, P, P,
                           sh.vec_x, tid);
      stage_tile<kThreads>(dst + kT * LDX, kLdK, Bs, sh.b_row, kT, Q - s0,
                           kKC, N, sh.vec_bc, tid);
      stage_tile<kThreads>(
          dst + kT * LDX + kT * kLdK, kLdK,
          a.dS + (bc * H + h0 + i) * static_cast<int64_t>(P) * N, N, P, P,
          kKC, N, sh.vec_ds, tid);
      return;
    }
    i -= n_s;
    const int r = st + i / per_r;
    const int k = i % per_r;
    const int t0 = r * kT;
    if (k < nkc) {  // C_r and B_s, columns [32 k, 32 k + 32) of N
      const int kc = k * kKC;
      stage_tile<kThreads>(dst, kLdK, Cg + t0 * sh.b_row + kc, sh.b_row, kT,
                           Q - t0, kKC, N - kc, sh.vec_bc, tid);
      stage_tile<kThreads>(dst + kT * kLdK, kLdK, Bs + kc, sh.b_row, kT,
                           Q - s0, kKC, N - kc, sh.vec_bc, tid);
    } else {  // dy_r and x_s of head k - nkc
      const int u = k - nkc;
      stage_tile<kThreads>(dst, LDY, dyb + t0 * sh.x_row + u * P, sh.x_row,
                           kT, Q - t0, P, P, sh.vec_dy, tid);
      stage_tile<kThreads>(dst + kT * LDY, LDX, xs + u * P, sh.x_row, kT,
                           Q - s0, P, P, sh.vec_x, tid);
    }
  };

  prefetch<kSlots>(steps, stage);
  cp_async_wait<kSlots - 1>();  // dt has landed
  __syncthreads();
  scan_cs(a, sh, b, cs, dts);
  if (SMALL) {
    __syncthreads();
    fill_w<HB>(cs, dts, nh, s0, Q, Qpad, wS);
  }
  // (run's first barrier publishes cs and wS)

  // dx of the block's heads, rows 16 wm: the state's term (below, or from
  // launch 1), then += sum_t W_ts dy_t
  float dx[HB][NT][4];
  float cb[4][4];       // C_r . B_s^T
  float tsum[4][4];     // dCB summed over the block's heads
  float dbs[2][4];      // (N <= 32) the state's dB, 16 columns a warp
#pragma unroll
  for (int v = 0; v < HB; ++v) zero(dx[v]);
  zero(dbs);
  const int ra = wm * 16 + gq;  // this thread's rows of a tile: ra, ra + 8

  run<kSlots>(steps, stage, [&](int i, int slot) {
    const float* X = ring + slot * SLOT;
    if (SMALL && i < n_s) {  // the state's terms of head i
      const float* Bt = X + kT * LDX;      // [64][kLdK]: B_s
      const float* dSt = Bt + kT * kLdK;   // [P][kLdK]: dS of head i
      const float wa = wS[i * kT + ra];
      const float wb = wS[i * kT + ra + 8];
      float dsb[NT][4];  // dS B_s: rows 16 wm, P / 2 columns
      zero(dsb);
      warp_mma<NT, true, kKC / 8>(dsb, Bt + wm * 16 * kLdK, kLdK,
                                  dSt + wn * (P / 2) * kLdK, kLdK,
                                  (N + 7) / 8, NT);
#pragma unroll
      for (int v = 0; v < HB; ++v)
        if (v == i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dx[v][j][e] = (e < 2 ? wa : wb) * dsb[j][e];
      dw_rows<P>(X, LDX, dsb, ra, wn, red);
      // the state's dB: w_s (x_s dS), 16 columns a warp
      float part[2][4];
      zero(part);
      warp_mma<2, false, P / 8>(part, X + wm * 16 * LDX, LDX,
                                dSt + wn * 16, kLdK, P / 8,
                                min(2, max(0, (N - wn * 16 + 7) / 8)));
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dbs[j][e] += (e < 2 ? wa : wb) * part[j][e];
      __syncthreads();
      if (tid < kT && s0 + tid < Q)
        a.dw[(bc * H + h0 + i) * static_cast<int64_t>(Q) + s0 + tid] =
            red[tid] + red[kT + tid];
      if (i == nh - 1) {
        float* out = a.dBs + b.blkg * Q * static_cast<int64_t>(N);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int s = s0 + ra + 8 * (e >> 1);
            const int n = wn * 16 + j * 8 + 2 * tq + (e & 1);
            if (s < Q && n < N)
              out[static_cast<int64_t>(s) * N + n] = dbs[j][e];
          }
      }
      return;
    }
    i -= n_s;
    const int r = st + i / per_r;
    const int k = i % per_r;
    const int t0 = r * kT;
    if (k < nkc) {
      if (k == 0) zero(cb);
      warp_mma<4, true, kKC / 8>(cb, X + wm * 16 * kLdK, kLdK,
                                 X + (kT + wn * 32) * kLdK, kLdK,
                                 (min(kKC, N - k * kKC) + 7) / 8, 4);
      return;
    }
    const int u = k - nkc;
    const float* dyt = X;            // [64][LDY]: dy rows of tile r
    const float* xt = X + kT * LDY;  // [64][LDX]: x rows of tile st
    if (u == 0) zero(tsum);
    float dw[4][4];
    zero(dw);
    warp_mma<4, true, P / 8>(dw, dyt + wm * 16 * LDY, LDY,
                             xt + wn * 32 * LDX, LDX, P / 8, 4);
    const float* csu = cs + u * Qpad;
    const float* dtu = dts + u * Qpad;
    const int ta = t0 + ra;
    const float cst[2] = {csu[ta], csu[ta + 8]};
    float rs[2] = {0.f, 0.f};               // sum_s R_ts of rows ta, ta + 8
    float kcol[4][2] = {}, rcol[4][2] = {};  // column sums of kv and R
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int sl = wn * 32 + j * 8 + 2 * tq + (e & 1);
        const int s = s0 + sl;
        const int t = ta + 8 * (e >> 1);
        float wv = 0.f, dcb = 0.f, kv = 0.f;
        if (t < Q && s <= t) {
          const float L = exp_fast(cst[e >> 1] - csu[s]);
          kv = dw[j][e] * cb[j][e] * L;
          wv = cb[j][e] * L * dtu[s];
          dcb = dw[j][e] * L * dtu[s];
        }
        const float R = dcb * cb[j][e];
        tsum[j][e] += dcb;
        rs[e >> 1] += R;
        kcol[j][e & 1] += kv;
        rcol[j][e & 1] += R;
        Wt[sl * kLdW + ra + 8 * (e >> 1)] = wv;
      }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 1);
      rs[e] += __shfl_xor_sync(0xffffffffu, rs[e], 2);
    }
    if (tq == 0) {
      red[wn * kT + ra] = rs[0];
      red[wn * kT + ra + 8] = rs[1];
    }
    float* ku = Kacc + (u * 4 + wm) * kT + wn * 32 + 2 * tq;
    float* rku = Racc + (u * 4 + wm) * kT + wn * 32 + 2 * tq;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float kv = kcol[j][c], rv = rcol[j][c];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          kv += __shfl_xor_sync(0xffffffffu, kv, o);
          rv += __shfl_xor_sync(0xffffffffu, rv, o);
        }
        if (gq == 0) {
          ku[j * 8 + c] += kv;
          rku[j * 8 + c] += rv;
        }
      }
    __syncthreads();  // W^T and the row sums are whole
    if (tid < kT && t0 + tid < Q)
      a.rowR[((bc * H + h0 + u) * sh.n_rt + st) * static_cast<int64_t>(Q) +
             t0 + tid] = red[tid] + red[kT + tid];
    // dx_s += W^T dy_r
    float part[NT][4];
    zero(part);
    warp_mma<NT, false, kT / 8>(part, Wt + wm * 16 * kLdW, kLdW,
                                dyt + wn * (P / 2), LDY, kT / 8, NT);
#pragma unroll
    for (int v = 0; v < HB; ++v)
      if (v == u)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dx[v][j][e] += part[j][e];
    if (u == nh - 1) {  // the block's dCB tile of pair (r, st)
      float* out =
          a.T + (b.blkg * sh.n_pairs + pair_index(r, st)) * kT * kT;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out[(ra + 8 * (e >> 1)) * kT + wn * 32 + j * 8 + 2 * tq + (e & 1)] =
              tsum[j][e];
    }
  });

  __syncthreads();  // the K and colR sums are whole
  const int64_t hq = (bc * H + h0) * static_cast<int64_t>(Q);
  for (int i = tid; i < nh * kT; i += kThreads) {
    const int u = i / kT;
    const int c = i - u * kT;
    if (s0 + c >= Q) continue;
    const float* ku = Kacc + u * 4 * kT + c;
    const float* rku = Racc + u * 4 * kT + c;
    a.K[hq + u * Q + s0 + c] = ku[0] + ku[kT] + ku[2 * kT] + ku[3 * kT];
    a.colR[hq + u * Q + s0 + c] =
        rku[0] + rku[kT] + rku[2 * kT] + rku[3 * kT];
  }
  // dx: the state's term (here, or launch 1's) + sum_t W_ts dy_t
#pragma unroll
  for (int v = 0; v < HB; ++v) {
    if (v >= nh) break;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + ra + 8 * (e >> 1);
        const int p = wn * (P / 2) + j * 8 + 2 * tq + (e & 1);
        if (s < Q) {
          float* o = a.dx + (bc * Q + s) * sh.x_row +
                     static_cast<int64_t>(h0 + v) * P + p;
          *o = SMALL ? dx[v][j][e] : *o + dx[v][j][e];
        }
      }
  }
}

// ---- launch 3: ddt and dA; dB and dC -----------------------------------
// ddt and dA of head h: one warp a (batch x chunk)
__device__ __forceinline__ void dt_cta(const Args& a, const Shapes& sh,
                                       int h, float* sm) {
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
    const float* rowR = a.rowR + hq * sh.n_rt;  // [n_rt][Q]
    const float end = cs[Q - 1];
    float zsum = 0.f;
#pragma unroll 4
    for (int s = lane; s < Q; s += 32) {
      const float z = a.dw[hq + s] * exp_fast(end - cs[s]) * dts[s];
      zsum += z;
      float rr = 0.f;  // row s's R summed over the column tiles in order
      for (int c = 0; c <= s / kT; ++c) rr += rowR[c * Q + s];
      dcs[s] = rr - a.colR[hq + s] - z;
    }
    zsum = warp_sum(zsum);
    __syncwarp();
    if (lane == 0) dcs[Q - 1] += zsum;
    __syncwarp();
    suffix_scan(Q, dcs, lane);
    __syncwarp();
#pragma unroll 4
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

// dB and dC, once a group: (batch x chunk, group, 64 columns of N, 16 of
// the 64 rows) of a row tile r (dC_r = sum_{s <= r} T_rs B_s) or a column
// tile s (dB_s = sum_{r >= s} T_rs^T C_r + the state's part), T the
// blocks' dCB tiles summed in block order.  Levels of equal work, heaviest
// first: level k holds dC of row tile n_rt - 1 - k and dB of column tile
// k.  Warp w takes the rows' 8 columns 8 w.
constexpr int kGroupRows = 16;

__device__ __forceinline__ void group_cta(const Args& a, const Shapes& sh,
                                          int64_t i, float* sm) {
  constexpr int kPer = kGroupRows * kT / kThreads;  // T elements a thread
  float* Ts = sm;              // [16][kLdW]: rows of T (dC) or T^T (dB)
  float* Ms = Ts + kGroupRows * kLdW;  // [64][kLdN]: B_s (dC) or C_r (dB)
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int Q = sh.Q, N = sh.N, n_hb = sh.n_hb;
  const int n_nc = (N + kT - 1) / kT;
  const int quarters = kT / kGroupRows;
  const int64_t per_level = sh.BNc * sh.G * 2 * n_nc * quarters;
  const int level = static_cast<int>(i / per_level);
  i %= per_level;
  const int m0 = static_cast<int>(i % quarters) * kGroupRows;
  i /= quarters;
  const int n0 = static_cast<int>(i % n_nc) * kT;
  i /= n_nc;
  const bool dc = (i & 1) == 0;
  i >>= 1;
  const int g = static_cast<int>(i % sh.G);
  const int64_t bc = i / sh.G;
  const int tile = dc ? sh.n_rt - 1 - level : level;
  const int cols = min(kT, (N - n0 + 7) / 8 * 8);
  const int live = warp * 8 < cols ? 1 : 0;
  const int64_t tstride = static_cast<int64_t>(sh.n_pairs) * kT * kT;
  const float* Tg = a.T + (bc * sh.G + g) * n_hb * tstride;
  const float* M = (dc ? a.Bm : a.Cm) + bc * Q * sh.b_row +
                   static_cast<int64_t>(g) * N + n0;

  float acc[1][4];
  zero(acc);
  const int first = dc ? 0 : tile;
  const int last = dc ? tile : sh.n_rt - 1;
  for (int o = first; o <= last; ++o) {
    __syncthreads();  // the last pair's readers are done
    stage_tile<kThreads>(Ms, kLdN, M + o * kT * sh.b_row, sh.b_row, kT,
                         Q - o * kT, kT, N - n0, sh.vec_bc, tid);
    cp_async_commit();
    const float* Tp = Tg + (dc ? pair_index(tile, o) : pair_index(o, tile)) *
                               kT * kT;
    // element q of this thread: row m0 + mr, column c of the product's A,
    // read along T's rows (dC: rows of A; dB: its columns)
    float v[kPer] = {};
#pragma unroll 4
    for (int blk = 0; blk < n_hb; ++blk)
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int e = q * kThreads + tid;
        v[q] += __ldg(Tp + blk * tstride +
                      (dc ? m0 * kT + e
                          : (e / kGroupRows) * kT + m0 + e % kGroupRows));
      }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int e = q * kThreads + tid;
      Ts[dc ? (e / kT) * kLdW + e % kT
            : (e % kGroupRows) * kLdW + e / kGroupRows] = v[q];
    }
    cp_async_wait<0>();
    __syncthreads();
    warp_mma<1, false, kT / 8>(acc, Ts, kLdW, Ms + warp * 8, kLdN, kT / 8,
                               live);
  }
  const int n = n0 + warp * 8 + 2 * tq;
  if (!dc) {  // the state's part, summed over the blocks in order
    const float* dBs =
        a.dBs + (bc * sh.G + g) * n_hb * static_cast<int64_t>(Q) * N;
#pragma unroll 4
    for (int blk = 0; blk < n_hb; ++blk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = tile * kT + m0 + gq + 8 * (e >> 1);
        if (m < Q && n + (e & 1) < N)
          acc[0][e] += __ldg(dBs + (static_cast<int64_t>(blk) * Q + m) * N +
                             n + (e & 1));
      }
  }
  float* out = dc ? a.dC : a.dB;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int m = tile * kT + m0 + gq + 8 * (e >> 1);
    if (m < Q && n + (e & 1) < N)
      out[((bc * Q + m) * sh.G + g) * static_cast<int64_t>(N) + n + (e & 1)] =
          acc[0][e];
  }
}

// the H ddt CTAs first (their warps walk the batch x chunks), then the
// dB and dC CTAs
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sums_kernel(Args a, Shapes sh) {
  extern __shared__ __align__(16) float sm[];
  const int64_t i = blockIdx.x;
  if (i < sh.H)
    dt_cta(a, sh, static_cast<int>(i), sm);
  else
    group_cta(a, sh, i - sh.H, sm);
}

template <int P, int HB, bool SMALL>
int launch_all(const Args& a, Shapes sh, cudaStream_t s) {
  const int Hg = sh.H / sh.G;
  sh.n_hb = (Hg + HB - 1) / HB;
  const int64_t ctas = sh.BNc * sh.G * sh.n_hb * sh.n_rt;
  const int64_t ctas4 = sh.BNc * sh.G * 2 * sh.n_rt *
                       ((sh.N + kT - 1) / kT) * (kT / kGroupRows);
  if (ctas > 0x7fffffff || ctas4 + sh.H > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(ctas);

  const int64_t ctas1 = ctas * (1 + (sh.N + kT - 1) / kT);
  if (ctas1 > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem;
  cudaError_t err;
  if constexpr (!SMALL) {
    smem = sizeof(float) * state_smem_floats<P, HB>(sh.Qpad);
    err = allow_smem(ssd_bwd_state_kernel<P, HB>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_state_kernel<P, HB>
        <<<static_cast<unsigned>(ctas1), kThreads, smem, s>>>(a, sh);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  smem = sizeof(float) * tile_smem_floats<P, HB>(sh.Qpad);
  err = allow_smem(ssd_bwd_tiles_kernel<P, HB, SMALL>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_tiles_kernel<P, HB, SMALL><<<grid, kThreads, smem, s>>>(a, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  smem = sizeof(float) *
         imax(kWarps * 3 * sh.Qpad + kWarps,
              kGroupRows * kLdW + kT * kLdN);
  err = allow_smem(ssd_bwd_sums_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_sums_kernel<<<static_cast<unsigned>(sh.H + ctas4), kThreads, smem,
                        s>>>(a, sh);
  return static_cast<int>(cudaGetLastError());
}

// Where N <= 32 (SMALL), C.B^T is cheap beside a head's own products, so
// half the heads a block and two CTAs an SM (the dx fragments fit 128
// registers), and the tile CTAs take the state's terms (no launch 1).
template <int P>
int launch(const Args& a, const Shapes& sh, cudaStream_t s) {
  constexpr int HB = heads_per_block(P);
  if (sh.N <= kKC) return launch_all<P, HB / 2, true>(a, sh, s);
  return launch_all<P, HB, false>(a, sh, s);
}

}  // namespace
}  // namespace repro_torch

// Floats of workspace `ssd_chunk_bwd` needs (at most H head blocks): the
// dCB tiles [BNc, H, pairs, 64, 64], the state's dB [BNc, H, Q, N], the
// row sums of R by column tile [BNc, H, n_rt, Q] and three [BNc, H, Q]
// vectors.
extern "C" int64_t ssd_chunk_bwd_workspace(int BNc, int Q, int H, int N) {
  const int64_t n_rt = (Q + 63) / 64;
  const int64_t bh = static_cast<int64_t>(BNc) * H;
  return bh * (n_rt * (n_rt + 1) / 2 * 64 * 64 +
               static_cast<int64_t>(Q) * N + n_rt * Q + 3 * Q);
}

// x, dy [BNc, Q, H, P], dt [BNc, Q, H], A [H], B/C [BNc, Q, G, N],
// dS [BNc, H, P, N] (BNc = batch x chunks), fp32, contiguous (4-byte
// aligned suffices), one device; writes dx, ddt, dA [H], dB and dC
// [BNc, Q, G, N]; `ws` holds `ssd_chunk_bwd_workspace` floats.  P in {16,
// 32, 64, 128}, 1 <= N <= 256, H % G == 0, 1 <= Q <= 1024.  Three launches
// (two where N <= 32); returns the first nonzero cudaGetLastError() (0 on
// success).  counts: null, or int32 [1] on the card, to which the call
// adds one.
extern "C" int ssd_chunk_bwd(const void* x, const void* dt, const void* A,
                             const void* Bm, const void* Cm, const void* dy,
                             const void* dS, void* dx, void* ddt, void* dA,
                             void* dB, void* dC, void* ws, int BNc, int Q,
                             int H, int G, int P, int N, void* counts,
                             void* stream) {
  using namespace repro_torch;
  if (N < 1 || N > kMaxN || G < 1 || H < 1 || H % G != 0 || Q < 1 ||
      Q > kMaxQ || BNc < 1 || !(P == 16 || P == 32 || P == 64 || P == 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  Shapes sh{};
  sh.Q = Q;
  sh.H = H;
  sh.G = G;
  sh.N = N;
  sh.n_rt = (Q + kT - 1) / kT;
  sh.Qpad = sh.n_rt * kT;
  sh.n_pairs = sh.n_rt * (sh.n_rt + 1) / 2;
  sh.BNc = BNc;
  sh.x_row = static_cast<int64_t>(H) * P;
  sh.b_row = static_cast<int64_t>(G) * N;
  sh.vec_x = aligned(x);
  sh.vec_dy = aligned(dy);
  sh.vec_bc = N % 4 == 0 && aligned(Bm) && aligned(Cm);
  sh.vec_ds = N % 4 == 0 && aligned(dS);
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
  const int64_t bh = static_cast<int64_t>(BNc) * H;
  a.T = static_cast<float*>(ws);
  a.dBs = a.T + bh * sh.n_pairs * kT * kT;
  a.rowR = a.dBs + bh * Q * N;
  a.colR = a.rowR + bh * sh.n_rt * Q;
  a.K = a.colR + bh * Q;
  a.dw = a.K + bh * Q;
  a.counts = static_cast<int*>(counts);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 16:
      return launch<16>(a, sh, s);
    case 32:
      return launch<32>(a, sh, s);
    case 64:
      return launch<64>(a, sh, s);
    default:
      return launch<128>(a, sh, s);
  }
}
