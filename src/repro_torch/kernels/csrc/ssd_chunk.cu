// SSD (Mamba2) within-chunk kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_chunk`
// (src/repro/kernels/ssd_scan.py).  For every (batch, chunk) and head h,
// with cs = the inclusive cumsum over the chunk of dt * A[h]:
//   y[t, :] = sum_{s <= t} (C_t . B_s) * exp(cs_t - cs_s) * dt_s * x[s, :]
//   S[:, n] = sum_s exp(cs_{Q-1} - cs_s) * dt_s * B_s[n] * x[s, :]
// fp32 in and out.  x [B, Nc, Q, H, P], dt [B, Nc, Q, H], A [H]; B and C
// come per group, [B, Nc, Q, G, N], and head h reads group h / (H / G) in
// the index arithmetic, so nothing is broadcast to heads in memory.  The
// decay is always exp of a difference of cs, never a quotient of two exps
// (which overflows).  The cross-chunk recurrence stays outside
// (`repro_torch.models.ssm.ssd_chunked`).
//
// What bounds it on an H100: bytes at the serving shapes (x in, y out and
// S out dominate); its three products, C.B^T, scores @ (dt x) and the
// state's (w B)^T x, are below the card's operations-per-byte line only at
// the tensor cores' rate.  So all three run on the tensor cores:
// `mma.sync.m16n8k8` with TF32 operands and fp32 accumulators.  One TF32
// pass keeps 10 mantissa bits of each operand and misses the fp32 result
// by ~1e-3 of an output row's largest value at mamba2's shape, 10-30x the
// 1e-4 this kernel is held to; so each product runs in 3xTF32: every fp32
// operand is split into hi = cvt.rna.tf32(a) and lo = cvt.rna.tf32(a - hi)
// (round to nearest, ties away) and the product is summed as lo.hi + hi.lo
// + hi.hi in fp32, which leaves ~1e-6 (the lo.lo term, ~2^-22 of each
// product, is dropped).  The tensor cores' fp32 accumulation is not
// IEEE-rounded (it truncates), and along a chain of dependent mma.sync
// into one accumulator that bias grows with the chain.  So each step's
// products (at most 24 mma.sync) sum into a fresh fragment, which is then
// added to the running sum by an ordinary fp32 add.
//
// A Q = 256 chunk's Q x Q score matrix does not fit one CTA's shared
// memory, so the work is cut in 64-row tiles.  One launch holds two kinds
// of CTA on a 1-D grid, the heaviest first:
//   - a row CTA owns y rows [64 r, 64 r + 64) of a block of HB heads of one
//     group (HB = 1 or 2).  C.B^T depends on the group only, so for each
//     column tile c <= r (tiles above the diagonal are never visited) it
//     forms the 64 x 64 tile C_r . B_c^T once, in 32-column chunks of C and
//     B, into shared memory; then, head by head, it builds that head's
//     score fragments in registers from the shared tile, applying the
//     head's own decay exp(cs_t - cs_s) * dt_s and the causal mask, and
//     adds score @ x to the head's y, which stays in registers for the
//     whole row.  HB is about N / P: C.B^T costs N / P head-products a
//     tile, so at mamba2 (N = 128, P = 64) two heads a CTA make it half of
//     the CTA's products, against two thirds for one head; more heads
//     would cost HB x P / 4 accumulator registers a thread more and make
//     the heavy row tiles' CTAs fewer and longer.  hymba (N = 16) runs one.
//   - a state CTA owns S[h][:, 64 j, 64 j + 64) and walks the chunk in
//     32-row steps, weighting x by w_s = exp(cs_{Q-1} - cs_s) * dt_s as it
//     forms the A fragments.
// Tiles move by 16-byte `cp.async` into a ring of two slots, so the next
// step's tiles are in flight while one step is multiplied (three or four
// slots were slower on the card: the steps are not bound by the copies'
// latency); the split, the products and the ring are in tf32_mma.cuh,
// shared with the backward.  Shared-memory rows are padded so the fragment
// loads hit distinct banks: rows read along k (C, B chunks and the C.B^T
// tile) are 4 mod 32 floats long, rows read across k (x, and B in the
// state CTAs) 8 mod 32.  Where B/C rows are not 16-byte
// aligned (N not a multiple of 4, or a base pointer off 16 bytes) the same
// kernel stages them with 4-byte copies instead.  Every CTA gathers dt of
// its heads with one round of 4-byte copies and recomputes cs with a warp
// scan from shared memory.  A ragged Q (any length <= 1024) is masked
// here: rows and columns >= Q are zero-filled in shared memory and never
// stored, so the caller pads nothing.  8 warps: a row CTA's warp holds a
// 16 x P/2 tile of each head's y (and a 16 x 32 tile of C.B^T), a state
// CTA's warp an even share of the P x 64 tile of S.
#include "tf32_mma.cuh"

namespace repro_torch {
namespace {

constexpr int kT = 64;                 // rows of a y tile, columns of C.B^T
constexpr int kS = 32;                 // rows of s a state CTA's step stages
constexpr int kThreads = 256;          // 8 warps
constexpr int kMaxN = 256;
constexpr int kMaxQ = 1024;
constexpr int kKC = 32;                // state columns a C.B^T step stages
constexpr int kLdK = kKC + 4;          // C/B chunk row (4 mod 32 floats)
constexpr int kLdCB = kT + 4;          // C.B^T tile row (4 mod 32 floats)
constexpr int kMaxHeads = 2;           // heads of a row CTA
constexpr int kLdS = kT + 8;           // state CTA's B row (8 mod 32 floats)
constexpr int kSlots = 2;              // ring slots: 1 step in flight
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// x rows in shared memory: P + 8 floats (8 mod 32)
template <int P>
__host__ __device__ constexpr int ld_x() { return P + 8; }

// a ring slot of a row CTA: a C and a B chunk, or a 64-row x tile
template <int P>
__host__ __device__ constexpr int row_slot() {
  return imax(2 * kT * kLdK, kT * ld_x<P>());
}

// a ring slot of a state CTA: kS rows of x and of B
template <int P>
__host__ __device__ constexpr int state_slot() {
  return kS * (ld_x<P>() + kLdS);
}

// cs and dt of up to `cs_len` = heads x Qpad positions each (state CTAs:
// cs and w), then the row CTA's C.B^T tile and ring, or the state CTA's
// ring
template <int P>
size_t smem_bytes(int cs_len) {
  return sizeof(float) *
         (2 * static_cast<size_t>(cs_len) +
          imax(kT * kLdCB + kSlots * row_slot<P>(),
               kSlots * state_slot<P>()));
}

// All threads: dt of heads [h0, h0 + nh) into dts[k * Qpad + s], by 4-byte
// copies all in flight at once (the caller commits and waits).
__device__ __forceinline__ void gather_dt(const float* dtb, int H, int h0,
                                          int nh, int Q, int Qpad,
                                          float* dts, int tid) {
  for (int i = tid; i < nh * Q; i += kThreads) {
    const int k = i / Q;
    const int s = i - k * Q;
    cp_async4(dts + k * Qpad + s, dtb + static_cast<int64_t>(s) * H + h0 + k,
              true);
  }
}

// One warp: cs[s] = sum_{u <= s} dts[u] * a for s < Q, zeros (and zero
// dts) on [Q, Qpad).  Each lane sums a contiguous segment, then the lanes
// exchange their segment totals.  A segment's offset is the previous
// lane's inclusive sum, not this lane's inclusive sum less its own total:
// that difference rounds with the segment's later terms, so cs[s], and
// every y row that reads it, would move with the dt of positions after s
// (a prefill's padded tail against the real tokens that follow it).
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

// exp(x) as 2^(x log2 e) on the SFU (relative error ~2^-22; results below
// 2^-126 flush to 0)
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * kLog2e));
  return y;
}

struct Shapes {
  int Q, H, G, N, Qpad, n_rt, cs_len;
  int64_t x_row, b_row;  // row strides of [.., Q, H, P] and [.., Q, G, N]
  bool vec_x, vec_bc;
};

// ---- row CTA: y rows [64 r, 64 r + 64) of heads [h0, h0 + nh) ----------
// Per column tile c <= r: N / kKC steps form the C.B^T tile C_r . B_c^T in
// shared memory, then one step per head stages that head's x rows of the
// tile and adds (C.B^T * decay * dt, masked) @ x to the head's y, which
// stays in registers for the whole row.
template <int P, int HB>
__device__ __forceinline__ void row_cta(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ y, const Shapes& sh,
    int64_t bc, int g, int r, int h0, int nh, float* sm) {
  constexpr int LDX = ld_x<P>();
  constexpr int SLOT = row_slot<P>();
  constexpr int NT = P / 16;  // 8-column tiles of y per warp
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int wm = warp & 3;   // rows 16 wm ..
  const int wn = warp >> 2;  // columns: C.B^T 32 wn .., y wn P / 2 ..
  const int Q = sh.Q, N = sh.N, Qpad = sh.Qpad;
  const int t0 = r * kT;

  float* cs = sm;                         // [nh][Qpad]
  float* dts = sm + sh.cs_len;            // [nh][Qpad]
  float* CB = sm + 2 * sh.cs_len;         // [64][kLdCB]
  float* ring = CB + kT * kLdCB;          // kSlots x SLOT
  gather_dt(dt + bc * Q * sh.H, sh.H, h0, nh, Q, Qpad, dts, tid);
  cp_async_commit();

  const int64_t gn = static_cast<int64_t>(g) * N;
  const float* Cb = Cm + (bc * Q + t0) * sh.b_row + gn;
  const float* Bb = Bm + bc * Q * sh.b_row + gn;
  const float* xb = x + bc * Q * sh.x_row;
  const int nkc = (N + kKC - 1) / kKC;
  const int per = nkc + nh;  // steps per column tile
  const int ta = t0 + wm * 16 + gq;  // this thread's two rows
  const int tb = ta + 8;
  const bool live_a = ta < Q;
  const bool live_b = tb < Q;

  auto stage = [&](int st, int slot) {
    const int c = st / per;
    const int k = st - c * per;
    float* dst = ring + slot * SLOT;
    if (k < nkc) {  // C and B chunk k of tile c
      const int kc = k * kKC;
      const int cols = min(kKC, (N - kc + 7) / 8 * 8);
      stage_tile<kThreads>(dst, kLdK, Cb + kc, sh.b_row, kT, Q - t0, cols,
                           N - kc, sh.vec_bc, tid);
      stage_tile<kThreads>(dst + kT * kLdK, kLdK,
                           Bb + c * kT * sh.b_row + kc, sh.b_row, kT,
                           Q - c * kT, cols, N - kc, sh.vec_bc, tid);
    } else {  // head k - nkc's x rows of tile c
      stage_tile<kThreads>(dst, LDX,
                           xb + c * kT * sh.x_row +
                               static_cast<int64_t>(h0 + k - nkc) * P,
                           sh.x_row, kT, Q - c * kT, P, P, sh.vec_x, tid);
    }
  };

  float acc[HB][NT][4];
  float cb[4][4];
#pragma unroll
  for (int u = 0; u < HB; ++u)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) cb[j][e] = 0.f;

  // y of head u += (C.B^T * decay * dt, masked) @ x over column tile c
  auto y_step = [&](float (&yacc)[NT][4], int u, int c, const float* Xs) {
    const float* csh = cs + u * Qpad;
    const float* dth = dts + u * Qpad;
    const float cta = csh[ta];
    const float ctb = csh[tb];
    const bool diag = c == r;
    const float* cbr = CB + (wm * 16 + gq) * kLdCB;
    float part[NT][4] = {};  // this tile's share (see kernel note)
#pragma unroll 2
    for (int kk = 0; kk < kT / 8; ++kk) {
      const int sl = kk * 8 + tq;  // column of the tile
      const int s0 = c * kT + sl;
      const int s1 = s0 + 4;
      const float cs0 = csh[s0], cs1 = csh[s1];
      const float d0 = dth[s0], d1 = dth[s1];
      float v[4] = {cbr[sl] * exp_fast(cta - cs0) * d0,
                    cbr[8 * kLdCB + sl] * exp_fast(ctb - cs0) * d0,
                    cbr[sl + 4] * exp_fast(cta - cs1) * d1,
                    cbr[8 * kLdCB + sl + 4] * exp_fast(ctb - cs1) * d1};
      // causal mask on the diagonal tile (where s > t the exp may be inf);
      // rows >= Q are never stored but are kept finite
      if (!live_a || (diag && s0 > ta)) v[0] = 0.f;
      if (!live_b || (diag && s0 > tb)) v[1] = 0.f;
      if (!live_a || (diag && s1 > ta)) v[2] = 0.f;
      if (!live_b || (diag && s1 > tb)) v[3] = 0.f;
      const FragA a(v);
      const float* xp = Xs + sl * LDX + wn * (P / 2) + gq;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma_3xtf32(part[j], a, xp[j * 8], xp[4 * LDX + j * 8]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) yacc[j][e] += part[j][e];
    if (c == r) {  // the row's last tile: store
      const int64_t hp = static_cast<int64_t>(h0 + u) * P;
      const int col = wn * (P / 2) + 2 * tq;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (live_a)
          *reinterpret_cast<float2*>(
              y + (bc * Q + ta) * sh.x_row + hp + col + j * 8) =
              make_float2(yacc[j][0], yacc[j][1]);
        if (live_b)
          *reinterpret_cast<float2*>(
              y + (bc * Q + tb) * sh.x_row + hp + col + j * 8) =
              make_float2(yacc[j][2], yacc[j][3]);
      }
    }
  };

  const int steps = (r + 1) * per;
  prefetch<kSlots>(steps, stage);
  run<kSlots>(steps, stage, [&](int st, int slot) {
    if (st == 0 && warp < nh)  // dt has landed
      scan_head(A[h0 + warp], Q, Qpad, cs + warp * Qpad, dts + warp * Qpad,
                lane);
    const int c = st / per;
    const int k = st - c * per;
    const float* Xs = ring + slot * SLOT;
    if (k >= nkc) {
#pragma unroll
      for (int u = 0; u < HB; ++u)
        if (u == k - nkc) y_step(acc[u], u, c, Xs);
      return;
    }
    const int ksteps = (min(kKC, N - k * kKC) + 7) / 8;
    const float* Bs = Xs + kT * kLdK;
    float part[4][4] = {};  // this chunk's share (see kernel note)
    for (int kk = 0; kk < ksteps; ++kk) {
      const float* ca = Xs + (wm * 16 + gq) * kLdK + kk * 8 + tq;
      const float v[4] = {ca[0], ca[8 * kLdK], ca[4], ca[8 * kLdK + 4]};
      const FragA a(v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* bb = Bs + (wn * 32 + j * 8 + gq) * kLdK + kk * 8 + tq;
        mma_3xtf32(part[j], a, bb[0], bb[4]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) cb[j][e] += part[j][e];
    if (k == nkc - 1) {  // the tile is whole: to shared memory (the next
                         // step's barrier makes it visible)
      float* o = CB + (wm * 16 + gq) * kLdCB + wn * 32 + 2 * tq;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j * 8] = cb[j][0];
        o[j * 8 + 1] = cb[j][1];
        o[8 * kLdCB + j * 8] = cb[j][2];
        o[8 * kLdCB + j * 8 + 1] = cb[j][3];
#pragma unroll
        for (int e = 0; e < 4; ++e) cb[j][e] = 0.f;
      }
    }
  });
}

// ---- state CTA: S[h][:, n0, n0 + 64) -----------------------------------
template <int P>
__device__ __forceinline__ void state_cta(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    float* __restrict__ S, const Shapes& sh, int64_t bc, int h, int n0,
    float* sm) {
  constexpr int LDX = ld_x<P>();
  constexpr int XS = kS * LDX;
  constexpr int SLOT = state_slot<P>();
  // warps over the P x 64 tile: WM x WN, each MT x NS m16n8 tiles
  constexpr int WM = P / 16 < 4 ? P / 16 : 4;
  constexpr int WN = 8 / WM;
  constexpr int MT = P / 16 / WM;
  constexpr int NS = 8 / WN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int wm = warp % WM;
  const int wn = warp / WM;
  const int Q = sh.Q, N = sh.N, Qpad = sh.Qpad;
  const int g = h / (sh.H / sh.G);

  float* cs = sm;                // [Qpad]
  float* ws = sm + sh.cs_len;    // [Qpad]: dt, then w
  float* ring = sm + 2 * sh.cs_len;
  gather_dt(dt + bc * Q * sh.H, sh.H, h, 1, Q, Qpad, ws, tid);
  cp_async_commit();

  const float* xb = x + bc * Q * sh.x_row + static_cast<int64_t>(h) * P;
  const float* Bb =
      Bm + bc * Q * sh.b_row + static_cast<int64_t>(g) * N + n0;
  const int cols = min(kT, (N - n0 + 7) / 8 * 8);
  auto stage = [&](int st, int slot) {
    float* Xs = ring + slot * SLOT;
    const int s0 = st * kS;
    stage_tile<kThreads>(Xs, LDX, xb + s0 * sh.x_row, sh.x_row, kS, Q - s0,
                         P, P, sh.vec_x, tid);
    stage_tile<kThreads>(Xs + XS, kLdS, Bb + s0 * sh.b_row, sh.b_row, kS,
                         Q - s0, cols, N - n0, sh.vec_bc, tid);
  };
  const int steps = (Q + kS - 1) / kS;
  prefetch<kSlots>(steps, stage);
  cp_async_wait<kSlots - 1>();  // dt has landed
  __syncthreads();
  if (warp == 0) {
    scan_head(A[h], Q, Qpad, cs, ws, lane);
    __syncwarp();
    const float end = cs[Q - 1];
    for (int s = lane; s < Q; s += 32) ws[s] *= exp_fast(end - cs[s]);
  }

  float acc[MT][NS][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  // this warp's columns start past the state width: nothing to multiply
  const bool idle = n0 + wn * NS * 8 >= N;
  run<kSlots>(steps, stage, [&](int st, int slot) {
    if (idle) return;
    const float* Xs = ring + slot * SLOT;
    const float* Bs = Xs + XS;
    float part[MT][NS][4] = {};  // this step's share (see kernel note)
#pragma unroll
    for (int kk = 0; kk < kS / 8; ++kk) {
      const int sl = kk * 8 + tq;
      const float w0 = ws[st * kS + sl];
      const float w1 = ws[st * kS + sl + 4];
      // A[p, s] = x[s, p] * w_s
      FragA a[MT];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const float* xp = Xs + sl * LDX + (wm * MT + i) * 16 + gq;
        const float v[4] = {xp[0] * w0, xp[8] * w0, xp[4 * LDX] * w1,
                            xp[4 * LDX + 8] * w1};
        a[i] = FragA(v);
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int nt = wn * NS + j;
        if (n0 + nt * 8 >= N) continue;  // past the state width
        const float* bp = Bs + sl * kLdS + nt * 8 + gq;
#pragma unroll
        for (int i = 0; i < MT; ++i)
          mma_3xtf32(part[i][j], a[i], bp[0], bp[4 * kLdS]);
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  });

  // S [B, Nc, H, P, N]
  float* Sb = S + (bc * sh.H + h) * static_cast<int64_t>(P) * N;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int p = (wm * MT + i) * 16 + gq;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int n = n0 + (wn * NS + j) * 8 + 2 * tq;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ne = n + (e & 1);
        if (ne < N)
          Sb[static_cast<int64_t>(p + (e >> 1) * 8) * N + ne] = acc[i][j][e];
      }
    }
  }
}

// The 1-D grid: first the row CTAs, the last row tiles (the most column
// tiles) first, each (row tile, head block, group, batch x chunk); then the
// state CTAs, each (state tile, head, batch x chunk).
template <int P, int HB>
__global__ void __launch_bounds__(kThreads, P <= 64 ? 2 : 1)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ S, Shapes sh, int64_t BNc, int n_hb) {
  extern __shared__ __align__(16) float sm[];
  const int64_t per_r = static_cast<int64_t>(n_hb) * sh.G * BNc;
  int64_t i = blockIdx.x;
  if (i < sh.n_rt * per_r) {
    const int r = sh.n_rt - 1 - static_cast<int>(i / per_r);
    i %= per_r;
    const int hb = static_cast<int>(i % n_hb);
    i /= n_hb;
    const int g = static_cast<int>(i % sh.G);
    const int64_t bc = i / sh.G;
    // the group's heads dealt out evenly over its n_hb blocks
    const int Hg = sh.H / sh.G;
    const int q0 = hb * Hg / n_hb;
    const int q1 = (hb + 1) * Hg / n_hb;
    row_cta<P, HB>(x, dt, A, Bm, Cm, y, sh, bc, g, r, g * Hg + q0, q1 - q0,
                   sm);
    return;
  }
  i -= sh.n_rt * per_r;
  const int n_st = (sh.N + kT - 1) / kT;
  const int nt = static_cast<int>(i % n_st);
  i /= n_st;
  const int h = static_cast<int>(i % sh.H);
  const int64_t bc = i / sh.H;
  state_cta<P>(x, dt, A, Bm, S, sh, bc, h, nt * kT, sm);
}

// Heads a row CTA: about N / P, so that C.B^T, which costs N / P
// head-products a tile, is about half of the CTA's products, while the
// blocks stay small enough for their y accumulators to stay in registers
// (HB x P / 4 a thread) and for the heavy row tiles' CTAs to be many.
inline int heads_per_cta(int N, int P) {
  const int h = (N + P - 1) / P;
  return h < 1 ? 1 : (h > kMaxHeads ? kMaxHeads : h);
}

template <int P, int HB>
int launch_hb(const float* x, const float* dt, const float* A,
              const float* Bm, const float* Cm, float* y, float* S, int BNc,
              Shapes sh, cudaStream_t stream) {
  const int Hg = sh.H / sh.G;
  const int n_hb = (Hg + HB - 1) / HB;  // blocks of <= HB heads
  sh.cs_len = HB * sh.Qpad;
  const size_t smem = smem_bytes<P>(sh.cs_len);
  cudaError_t err = allow_smem(ssd_chunk_kernel<P, HB>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t ctas =
      static_cast<int64_t>(BNc) *
      (static_cast<int64_t>(sh.n_rt) * n_hb * sh.G +
       static_cast<int64_t>(sh.H) * ((sh.N + kT - 1) / kT));
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  ssd_chunk_kernel<P, HB><<<static_cast<unsigned>(ctas), kThreads, smem,
                            stream>>>(x, dt, A, Bm, Cm, y, S, sh, BNc, n_hb);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch(const float* x, const float* dt, const float* A, const float* Bm,
           const float* Cm, float* y, float* S, int BNc, const Shapes& sh,
           cudaStream_t stream) {
  static_assert(kMaxHeads == 2, "one instantiation per head block size");
  if (heads_per_cta(sh.N, P) == 1)
    return launch_hb<P, 1>(x, dt, A, Bm, Cm, y, S, BNc, sh, stream);
  return launch_hb<P, 2>(x, dt, A, Bm, Cm, y, S, BNc, sh, stream);
}

}  // namespace
}  // namespace repro_torch

// x [BNc, Q, H, P], dt [BNc, Q, H], A [H], B/C [BNc, Q, G, N] (BNc = batch
// x chunks), fp32, contiguous, one device; y [BNc, Q, H, P] and
// S [BNc, H, P, N] are written (y 16-byte aligned).  P in {16, 32, 64,
// 128}, 1 <= N <= 256, H % G == 0, Q <= 1024.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int ssd_chunk(const void* x, const void* dt, const void* A,
                         const void* Bm, const void* Cm, void* y, void* S,
                         int BNc, int Q, int H, int G, int P, int N,
                         void* stream) {
  using namespace repro_torch;
  if (N < 1 || N > kMaxN || G < 1 || H % G != 0 || Q < 1 || Q > kMaxQ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  sh.x_row = static_cast<int64_t>(H) * P;
  sh.b_row = static_cast<int64_t>(G) * N;
  sh.vec_x = aligned(x);
  sh.vec_bc = N % 4 == 0 && aligned(Bm) && aligned(Cm);
  const float* xf = static_cast<const float*>(x);
  const float* df = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* bf = static_cast<const float*>(Bm);
  const float* cf = static_cast<const float*>(Cm);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(S);
  switch (P) {
    case 16:
      return launch<16>(xf, df, af, bf, cf, yf, sf, BNc, sh, s);
    case 32:
      return launch<32>(xf, df, af, bf, cf, yf, sf, BNc, sh, s);
    case 64:
      return launch<64>(xf, df, af, bf, cf, yf, sf, BNc, sh, s);
    case 128:
      return launch<128>(xf, df, af, bf, cf, yf, sf, BNc, sh, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
