// Backward of the Mamba-2 SSD chunked scan for Hopper (sm_90a), CUDA C++.
//
// No TPU kernel to replace: the reference differentiates its plain jnp
// scan (`ssd_reference`, src/repro/models/layers.py) with
// `jax.value_and_grad`. This computes the same gradients as autograd
// through ../ref.py `ssd_reference`, for a single B/C group, from the
// forward's operands alone, so it does not depend on the route the forward
// took. ../ref.py `ssd_backward_passes_ref` is this decomposition in plain
// PyTorch.
//
// Per (row, head) and chunk of Q positions, with a = dt·A, cum its prefix
// sum in the chunk, T the chunk's total, u = dt·x, L_ij = exp(cum_i - cum_j)
// for j <= i, h_in the state before the chunk and dh_out the gradient of
// the state after it:
//   du_j  = Σ_{i>=j} (C_i·B_j) L_ij dy_i + exp(T - cum_j) dh_out B_j
//   dx_j  = dt_j du_j, and the direct part of ddt_j is x_j·du_j
//   dC_i  = Σ_{j<=i} L_ij (dy_i·u_j) B_j + exp(cum_i) h_inᵀ dy_i
//   dB_j  = Σ_{i>=j} L_ij (dy_i·u_j) C_i + exp(T - cum_j) dh_outᵀ u_j
//   dcum  = every exponent's share; da = its reverse prefix sum;
//           ddt += A·da, dA = Σ dt·da
//   dh_in = exp(T) dh_out + Σ_i exp(cum_i) dy_i ⊗ C_i   (reverse over chunks)
//
// Two routes, chosen by the wrapper from dtypes, shapes and alignment
// (ops._bwd_route), both launched by the one C entry point below and
// deterministic (no atomics: every sum runs in a fixed order). Both write
// the same workspace in the same four steps: the chunks' states and shares
// of dh, the states carried forward and their gradients backward, the
// gradients of each (row, chunk, head), and the sums over heads and
// chunks.
//
// cuda_core (f32 or mixed dtypes, other widths or chunks, unaligned rows;
// the first version): products in f32 on CUDA cores from the operands as
// they come (bf16 or f32):
//   1. `ssd_bwd_chunk_kernel`, one block a (tile of 32 x 64 of the [P, N]
//      state, chunk, row, head, mode): cum (a warp scan, written to the
//      workspace) and either the chunk's own state Σ_j exp(T - cum_j) u_j ⊗
//      B_j (mode 0) or its share of dh, Σ_i exp(cum_i) dy_i ⊗ C_i (mode 1).
//   2. `ssd_bwd_state_kernel`, a thread per state element of a (row, head),
//      serial over chunks: in place, the state before each chunk, then in
//      reverse the gradient of the state after each chunk (the last one's
//      is the final state's cotangent, zero without one).
//   3. `ssd_bwd_grad_kernel`, one block a (row, chunk, head): two sweeps
//      over tiles of 32 rows. Sweep A holds a tile of queries i and walks
//      the key tiles j <= i: dC and the row sums of M_ij = (dy_i·u_j)
//      (C_i·B_j) L_ij. Sweep B holds a tile of keys j and walks the query
//      tiles i >= j: du, dB and the column sums of M. Both recompute the
//      32 x 32 tiles of C·Bᵀ and dy·uᵀ (the mask applied before the exp);
//      the state terms go through slices of 32 rows of h_in or dh_out
//      staged in shared memory. Then dcum, its reverse prefix sum (a warp
//      scan), ddt, dx, and the head's share of dA; dB and dC a head's own.
//   4. `ssd_bwd_reduce_kernel` sums dB and dC over the heads in order,
//      `ssd_bwd_reduce_da_kernel` dA over rows and chunks in order.
//
// tensor_core (bf16 x, dy, B and C with 16-byte aligned rows, P and N
// multiples of 16 up to 256, Q a multiple of 64 up to 256, a working set
// that fits a block): the same steps on `mma.sync.m16n8k16` (bf16 in, f32
// accumulate; helpers in ssd_mma.cuh, shared with the forward), from
// `ldmatrix` fragments of padded shared rows loaded with 16-byte
// `cp.async`:
//   1. `ssd_bwd_chunk_tc_kernel`: the forward's chunk pass with other row
//      weights, for both the state (x, B ∘ dt·exp(T - cum)) and the share
//      of dh (dy, C ∘ exp(cum)).
//   2. `ssd_bwd_state_tc_kernel`: step 2 in float4, each thread with
//      several chunks' loads in flight.
//   3. `ssd_bwd_grad_tc_kernel`: one block a (row, chunk, head) holding the
//      chunk's C, B, x and dy, warps of 16 rows, the two sweeps with the
//      scores in registers (sweep B's transposed, so a warp's rows are its
//      keys) and the state terms' states staged as hi + lo pairs.
//   4. the same sums.
// The operands computed in f32 (the weighted B and C rows, the masked
// scores W = (C·Bᵀ) ∘ L and V = (dy·xᵀ) ∘ dt_j ∘ L, the carried states and
// their gradients) enter the products as hi + lo bf16 pairs, ~16 bits of
// mantissa where one bf16 rounding keeps 8; x, dy, B and C enter as they
// come, so C·Bᵀ and dy·xᵀ are exact products summed in f32, and dt enters
// as an f32 scale of rows or columns, never through u = dt·x.
// ../ref.py `ssd_backward_passes_ref(split_operands=True)` is this route in
// plain PyTorch.
//   The gradient pass's block holds ~142 KB of shared memory and 225
// registers a thread at mamba2's widths: one block of 8 warps an SM. Two
// sweeps in one block (not two kernels) because a warp that owns row tile
// w walks w + 1 key tiles in sweep A and 8 - w query tiles in sweep B, 9
// in all for every warp, and the chunk's operands are loaded once; more
// than one block an SM would need both halves of that: under ~113 KB and
// 128 registers, which the accumulators of sweep B (du and dB, 96 f32 a
// thread) do not leave. P and N are compile-time constants at mamba2's and
// zamba2's widths, which unrolls the products' loops (0.47 -> 0.30 ms at
// mamba2's training shape on the H100, chip_smoke's `ssd_bwd timing`).
//
// What bounds it: operations, at the bf16 tensor-core peak: at mamba2's
// training shape (B = 2, S = 1024, 80x64, N = 128, chunk 128) ~22.6 GFLOP,
// 0.023 ms, against 66 MB of operands and gradients (0.020 ms); the passes
// also move ~0.3 GB of f32 states, gradients and per-head partial sums
// through the workspace.
// Positions past S are the forward's zero padding (dt = x = B = C = 0, and
// dy = 0): they contribute nothing, and their gradients are not written.
//
// Layouts (the last dimension of every input has stride 1; the others are
// strides the wrapper passes, so slices of the model's fused projection
// need no copy):
//   x, dy  [B, S, H, P]  f32 or bf16 (dy in x's type)   dt [B, S, H] f32
//   Bm, Cm [B, S, N]     f32 or bf16                    A  [H] f32
//   dfinal [B, H, P, N]  f32, contiguous, or null
//   dx [B, S, H, P] in x's type, ddt [B, S, H] f32, dA [H] f32,
//   dB, dC [B, S, N] in B's type: all contiguous.
// The workspace (f32, ops._bwd_workspace_bytes): cum [B, C, H, Q], the
// states [B, C, H, P, N], their gradients [B, C, H, P, N], a head's dB and
// dC [B, S, H, N] each, a (row, chunk, head)'s dA [B, C, H].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "ssd_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // chunk rows a tile (pass 3)
constexpr int kOutP = 32, kOutN = 64;  // state elements a pass-1 block
constexpr int kSmemLimit = 232448;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Strides {
  long long x_b, x_s, x_h;     // x   (p stride 1)
  long long dt_b, dt_s;        // dt  (h stride 1)
  long long b_b, b_s;          // Bm  (n stride 1)
  long long c_b, c_s;          // Cm  (n stride 1)
  long long dy_b, dy_s, dy_h;  // dy  (p stride 1)
};

struct Dims {
  int B, S, H, P, N, Q, C;  // C: chunks
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// cum_s[q] = dt_s[0] a + ... + dt_s[q] a over the chunk, by warp 0: each lane
// sums a run, then a shuffle scan adds the runs before it (the forward's
// order, ../csrc/ssd.cu chunk_cumsum)
__device__ __forceinline__ void chunk_cumsum(const float* dt_s, float a, float* cum_s, int Q,
                                             int tid) {
  if (tid >= 32) return;
  const int per = (Q + 31) / 32;
  const int lo = min(Q, tid * per), hi = min(Q, lo + per);
  float run = 0.f;
  for (int q = lo; q < hi; ++q) {
    run += dt_s[q] * a;
    cum_s[q] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (tid >= off) incl += v;
  }
  const float base = incl - run;
  for (int q = lo; q < hi; ++q) cum_s[q] += base;
}

// v_s[q] = v_s[q] + ... + v_s[Q-1] in place, by warp 0: the reverse of
// chunk_cumsum's scan
__device__ __forceinline__ void chunk_suffix_sum(float* v_s, int Q, int tid) {
  if (tid >= 32) return;
  const int per = (Q + 31) / 32;
  const int lo = min(Q, tid * per), hi = min(Q, lo + per);
  float run = 0.f;
  for (int q = hi - 1; q >= lo; --q) {
    run += v_s[q];
    v_s[q] = run;
  }
  float incl = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_down_sync(0xffffffffu, incl, off);
    if (tid + off < 32) incl += v;
  }
  const float base = incl - run;
  for (int q = lo; q < hi; ++q) v_s[q] += base;
}

// Pass 1. blockIdx.x = tile + tiles * (mode + 2 * (b * C + c)), blockIdx.y = h.
template <typename XT, typename BT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_chunk_kernel(
    const XT* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const BT* __restrict__ Bm, const BT* __restrict__ Cm, const XT* __restrict__ dy,
    float* __restrict__ cum_ws, float* __restrict__ states, float* __restrict__ dstates, Dims d,
    Strides st, int n_tiles) {
  const int tiles = ((d.P + kOutP - 1) / kOutP) * n_tiles;
  const int tile = blockIdx.x % tiles, rest = blockIdx.x / tiles;
  const int mode = rest & 1, bc = rest >> 1, b = bc / d.C, c = bc % d.C;
  const int h = blockIdx.y, tid = threadIdx.x;
  const int p0 = (tile / n_tiles) * kOutP, n0 = (tile % n_tiles) * kOutN;
  const int Q = d.Q, s0 = c * Q;

  extern __shared__ float smem[];
  float* cum_s = smem;            // [Q]
  float* w_s = cum_s + Q;         // [Q]: dt, then the rows' weights
  float* a_s = w_s + Q;           // [kTile][kOutP]
  float* b_s = a_s + kTile * kOutP;  // [kTile][kOutN]

  const float* dtb = dt + b * st.dt_b + h;
  for (int q = tid; q < Q; q += kThreads)
    w_s[q] = s0 + q < d.S ? dtb[(long long)(s0 + q) * st.dt_s] : 0.f;
  __syncthreads();
  chunk_cumsum(w_s, A[h], cum_s, Q, tid);
  __syncthreads();
  const float total = cum_s[Q - 1];
  if (mode == 0 && tile == 0) {
    float* cw = cum_ws + ((size_t)bc * d.H + h) * Q;
    for (int q = tid; q < Q; q += kThreads) cw[q] = cum_s[q];
  }
  __syncthreads();
  for (int q = tid; q < Q; q += kThreads)
    w_s[q] = mode == 0 ? w_s[q] * expf(total - cum_s[q]) : expf(cum_s[q]);

  const XT* src = mode == 0 ? x + b * st.x_b + h * st.x_h : dy + b * st.dy_b + h * st.dy_h;
  const long long src_s = mode == 0 ? st.x_s : st.dy_s;
  const BT* bsrc = mode == 0 ? Bm + b * st.b_b : Cm + b * st.c_b;
  const long long bsrc_s = mode == 0 ? st.b_s : st.c_s;
  const int tp = tid >> 3, tn = tid & 7;  // out[p0 + tp][n0 + tn + 8k], k < 8
  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.f;
  for (int j0 = 0; j0 < Q; j0 += kTile) {
    __syncthreads();  // w_s written; the previous tile read
    for (int i = tid; i < kTile * kOutP; i += kThreads) {
      const int jj = i / kOutP, p = p0 + i % kOutP, q = j0 + jj;
      a_s[i] = q < Q && s0 + q < d.S && p < d.P
                   ? w_s[q] * to_f32(src[(long long)(s0 + q) * src_s + p])
                   : 0.f;
    }
    for (int i = tid; i < kTile * kOutN; i += kThreads) {
      const int jj = i / kOutN, n = n0 + i % kOutN, q = j0 + jj;
      b_s[i] = q < Q && s0 + q < d.S && n < d.N
                   ? to_f32(bsrc[(long long)(s0 + q) * bsrc_s + n])
                   : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kTile; ++jj) {
      const float av = a_s[jj * kOutP + tp];
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] += av * b_s[jj * kOutN + tn + 8 * k];
    }
  }
  const int p = p0 + tp;
  if (p < d.P) {
    float* out = (mode == 0 ? states : dstates) + ((size_t)bc * d.H + h) * d.P * d.N;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int n = n0 + tn + 8 * k;
      if (n < d.N) out[(size_t)p * d.N + n] = acc[k];
    }
  }
}

// Pass 2, a thread per state element of a (row, head), serial over chunks:
// slot c of `states` becomes the state before chunk c, slot c of `dstates`
// the gradient of the state after chunk c.
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_kernel(
    const float* __restrict__ cum_ws, float* __restrict__ states, float* __restrict__ dstates,
    const float* __restrict__ dfinal, Dims d) {
  const size_t PN = (size_t)d.P * d.N;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  float carry = 0.f;
  for (int c = 0; c < d.C; ++c) {
    const size_t slot = ((size_t)b * d.C + c) * d.H + h;
    const float decay = expf(cum_ws[slot * d.Q + d.Q - 1]);
    float* s = states + slot * PN + e;
    const float v = *s;
    *s = carry;
    carry = carry * decay + v;
  }
  float dcarry = dfinal != nullptr ? dfinal[((size_t)b * d.H + h) * PN + e] : 0.f;
  for (int c = d.C - 1; c >= 0; --c) {
    const size_t slot = ((size_t)b * d.C + c) * d.H + h;
    const float decay = expf(cum_ws[slot * d.Q + d.Q - 1]);
    float* s = dstates + slot * PN + e;
    const float v = *s;
    *s = dcarry;
    dcarry = dcarry * decay + v;
  }
}

// Pass 3's shared memory, in floats: seven [Q] vectors, six tiles of 32
// rows (two [32][N+1] and two [32][P+1] operands, a [32][N+1] and a
// [32][P+1] accumulator), three [32][33] score tiles, kWarps partial sums.
__host__ __device__ inline size_t grad_smem_floats(int P, int N, int Q) {
  return 7 * (size_t)Q + 3 * (size_t)kTile * (N + 1) + 3 * (size_t)kTile * (P + 1) +
         3 * (size_t)kTile * (kTile + 1) + kWarps;
}

// The 32 x 32 score tiles of query rows i0 + r (ci_s: C, dyi_s: dy) against
// key rows j0 + jj (bj_s: B, uj_s: u = dt·x): w = (C·B) L, v = (dy·u) L,
// m = v (C·B), zero where the key comes after the query or past the chunk.
__device__ __forceinline__ void score_tiles(const float* ci_s, const float* dyi_s,
                                            const float* bj_s, const float* uj_s,
                                            const float* cum_s, int i0, int j0, int Q, int P,
                                            int N, float* w_s, float* v_s, float* m_s,
                                            int tid) {
  const int NP = N + 1, PP = P + 1, TP = kTile + 1;
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int r = e >> 5, jj = e & 31;
    const int qi = i0 + r, qj = j0 + jj;
    float w = 0.f, v = 0.f, m = 0.f;
    if (qj <= qi && qi < Q) {
      float g = 0.f, dd = 0.f;
      for (int n = 0; n < N; ++n) g += ci_s[r * NP + n] * bj_s[jj * NP + n];
      for (int p = 0; p < P; ++p) dd += dyi_s[r * PP + p] * uj_s[jj * PP + p];
      const float l = expf(cum_s[qi] - cum_s[qj]);
      w = g * l;
      v = dd * l;
      m = v * g;
    }
    w_s[r * TP + jj] = w;
    v_s[r * TP + jj] = v;
    m_s[r * TP + jj] = m;
  }
}

// Pass 3, one block a (row x chunk, head).
template <typename XT, typename BT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_grad_kernel(
    const XT* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const BT* __restrict__ Bm, const BT* __restrict__ Cm, const XT* __restrict__ dy,
    const float* __restrict__ cum_ws, const float* __restrict__ states,
    const float* __restrict__ dstates, int has_dfinal, XT* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ db_part, float* __restrict__ dc_part,
    float* __restrict__ da_part, Dims d, Strides st) {
  const int bc = blockIdx.x, b = bc / d.C, c = bc % d.C, h = blockIdx.y;
  const int Q = d.Q, P = d.P, N = d.N, s0 = c * Q;
  const int NP = N + 1, PP = P + 1, TP = kTile + 1;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t PN = (size_t)P * N;

  extern __shared__ float smem[];
  float* cum_s = smem;              // [Q]
  float* dt_s = cum_s + Q;          // [Q]
  float* rowm_s = dt_s + Q;         // [Q]: Σ_j M_ij
  float* colm_s = rowm_s + Q;       // [Q]: Σ_i M_ij
  float* cterm_s = colm_s + Q;      // [Q]: C_i·exp(cum_i) h_inᵀ dy_i
  float* s_s = cterm_s + Q;         // [Q]: u_j·exp(T - cum_j) dh_out B_j
  float* xdu_s = s_s + Q;           // [Q]: x_j·du_j
  float* fn_s = xdu_s + Q;          // [32][N+1]: the held tile's C (A) or B (B)
  float* vn_s = fn_s + kTile * NP;  // [32][N+1]: the walked tile's B or C; state slices
  float* an_s = vn_s + kTile * NP;  // [32][N+1]: dC (A) or dB (B)
  float* fp_s = an_s + kTile * NP;  // [32][P+1]: the held tile's dy (A) or u (B)
  float* vp_s = fp_s + kTile * PP;  // [32][P+1]: the walked tile's u or dy
  float* ap_s = vp_s + kTile * PP;  // [32][P+1]: du (B)
  float* w_s = ap_s + kTile * PP;   // [32][33]
  float* v_s = w_s + kTile * TP;    // [32][33]
  float* m_s = v_s + kTile * TP;    // [32][33]
  float* red_s = m_s + kTile * TP;  // [kWarps]

  const XT* xb = x + b * st.x_b + h * st.x_h;
  const XT* dyb = dy + b * st.dy_b + h * st.dy_h;
  const BT* Bb = Bm + b * st.b_b;
  const BT* Cb = Cm + b * st.c_b;
  const float* cw = cum_ws + ((size_t)bc * d.H + h) * Q;
  const float* h_in = states + ((size_t)bc * d.H + h) * PN;
  const float* dh_out = dstates + ((size_t)bc * d.H + h) * PN;
  const bool has_h = c > 0;
  const bool has_dh = c < d.C - 1 || has_dfinal;
  const float a = A[h];

  const float* dtb = dt + b * st.dt_b + h;
  for (int q = tid; q < Q; q += kThreads) {
    cum_s[q] = cw[q];
    dt_s[q] = s0 + q < d.S ? dtb[(long long)(s0 + q) * st.dt_s] : 0.f;
    rowm_s[q] = colm_s[q] = cterm_s[q] = s_s[q] = xdu_s[q] = 0.f;
  }
  const float total = cw[Q - 1];
  // Σ dh_out ∘ h_in, in a fixed order
  float hdh = 0.f;
  if (has_h && has_dh) {
    float part = 0.f;
    for (size_t e = tid; e < PN; e += kThreads) part += dh_out[e] * h_in[e];
    part = warp_sum(part);
    if (lane == 0) red_s[warp] = part;
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) hdh += red_s[w];
  }
  __syncthreads();

  // rows [r0, r0 + 32) of an [S]-long operand into a [32][width + 1] tile,
  // scaled per row by `scale` (null: 1); zero past the chunk or S
  auto load_n = [&](float* dst, const BT* src, long long row_s, int r0) {
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i - r * N, q = r0 + r;
      dst[r * NP + n] = q < Q && s0 + q < d.S ? to_f32(src[(long long)(s0 + q) * row_s + n])
                                              : 0.f;
    }
  };
  auto load_p = [&](float* dst, const XT* src, long long row_s, int r0, bool times_dt) {
    for (int i = tid; i < kTile * P; i += kThreads) {
      const int r = i / P, p = i - r * P, q = r0 + r;
      float v = 0.f;
      if (q < Q && s0 + q < d.S) {
        v = to_f32(src[(long long)(s0 + q) * row_s + p]);
        if (times_dt) v *= dt_s[q];
      }
      dst[r * PP + p] = v;
    }
  };
  // rows [p0, p0 + 32) of a [P][N] state into vn_s
  auto load_state = [&](const float* src, int p0) {
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i - r * N;
      vn_s[r * NP + n] = p0 + r < P ? src[(size_t)(p0 + r) * N + n] : 0.f;
    }
  };
  // Σ over a row of `t` (width `width`, row stride `stride`) times `u`, a
  // warp a row, for the 32 rows of a tile
  auto row_dots = [&](const float* t, const float* u, int width, int stride, float* out,
                      int r0) {
    for (int r = warp; r < kTile; r += kWarps) {
      float part = 0.f;
      for (int k = lane; k < width; k += 32) part += t[r * stride + k] * u[r * stride + k];
      part = warp_sum(part);
      if (lane == 0 && r0 + r < Q) out[r0 + r] = part;
    }
  };

  // ---- sweep A: a tile of queries i, the key tiles j <= i
  for (int i0 = 0; i0 < Q; i0 += kTile) {
    load_n(fn_s, Cb, st.c_s, i0);
    load_p(fp_s, dyb, st.dy_s, i0, false);
    for (int i = tid; i < kTile * NP; i += kThreads) an_s[i] = 0.f;
    __syncthreads();
    if (has_h) {  // dC_i += exp(cum_i) h_inᵀ dy_i, over slices of 32 rows of h_in
      for (int p0 = 0; p0 < P; p0 += kTile) {
        load_state(h_in, p0);
        __syncthreads();
        const int np = min(kTile, P - p0);
        for (int i = tid; i < kTile * N; i += kThreads) {
          const int r = i / N, n = i - r * N;
          float acc = an_s[r * NP + n];
          for (int pp = 0; pp < np; ++pp) acc += fp_s[r * PP + p0 + pp] * vn_s[pp * NP + n];
          an_s[r * NP + n] = acc;
        }
        __syncthreads();
      }
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        if (i0 + r < Q) an_s[r * NP + n] *= expf(cum_s[i0 + r]);
      }
      __syncthreads();
      row_dots(fn_s, an_s, N, NP, cterm_s, i0);
    }
    for (int j0 = 0; j0 <= i0; j0 += kTile) {
      __syncthreads();  // vn_s, vp_s free
      load_n(vn_s, Bb, st.b_s, j0);
      load_p(vp_s, xb, st.x_s, j0, true);
      __syncthreads();
      score_tiles(fn_s, fp_s, vn_s, vp_s, cum_s, i0, j0, Q, P, N, w_s, v_s, m_s, tid);
      __syncthreads();
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int r = i / N, n = i - r * N;
        float acc = an_s[r * NP + n];
        for (int jj = 0; jj < kTile; ++jj) acc += v_s[r * TP + jj] * vn_s[jj * NP + n];
        an_s[r * NP + n] = acc;
      }
      if (tid < kTile) {
        float acc = 0.f;
        for (int jj = 0; jj < kTile; ++jj) acc += m_s[tid * TP + jj];
        if (i0 + tid < Q) rowm_s[i0 + tid] += acc;
      }
    }
    __syncthreads();
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i - r * N, q = i0 + r;
      if (q < Q && s0 + q < d.S)
        dc_part[(((size_t)b * d.S + s0 + q) * d.H + h) * N + n] = an_s[r * NP + n];
    }
    __syncthreads();
  }

  // ---- sweep B: a tile of keys j, the query tiles i >= j
  for (int j0 = 0; j0 < Q; j0 += kTile) {
    load_n(fn_s, Bb, st.b_s, j0);
    load_p(fp_s, xb, st.x_s, j0, true);
    for (int i = tid; i < kTile * NP; i += kThreads) an_s[i] = 0.f;
    for (int i = tid; i < kTile * PP; i += kThreads) ap_s[i] = 0.f;
    __syncthreads();
    if (has_dh) {  // du_j += e dh_out B_j, dB_j += e dh_outᵀ u_j, e = exp(T - cum_j)
      for (int p0 = 0; p0 < P; p0 += kTile) {
        load_state(dh_out, p0);
        __syncthreads();
        const int np = min(kTile, P - p0);
        for (int e = tid; e < kTile * kTile; e += kThreads) {
          const int jj = e >> 5, pp = e & 31;
          if (pp < np) {
            float acc = 0.f;
            for (int n = 0; n < N; ++n) acc += fn_s[jj * NP + n] * vn_s[pp * NP + n];
            ap_s[jj * PP + p0 + pp] = acc;
          }
        }
        for (int i = tid; i < kTile * N; i += kThreads) {
          const int jj = i / N, n = i - jj * N;
          float acc = an_s[jj * NP + n];
          for (int pp = 0; pp < np; ++pp) acc += fp_s[jj * PP + p0 + pp] * vn_s[pp * NP + n];
          an_s[jj * NP + n] = acc;
        }
        __syncthreads();
      }
      for (int i = tid; i < kTile * PP; i += kThreads) {
        const int jj = i / PP;
        if (j0 + jj < Q) ap_s[i] *= expf(total - cum_s[j0 + jj]);
      }
      for (int i = tid; i < kTile * NP; i += kThreads) {
        const int jj = i / NP;
        if (j0 + jj < Q) an_s[i] *= expf(total - cum_s[j0 + jj]);
      }
      __syncthreads();
      row_dots(fp_s, ap_s, P, PP, s_s, j0);
    }
    for (int i0 = j0; i0 < Q; i0 += kTile) {
      __syncthreads();  // vn_s, vp_s free
      load_n(vn_s, Cb, st.c_s, i0);
      load_p(vp_s, dyb, st.dy_s, i0, false);
      __syncthreads();
      score_tiles(vn_s, vp_s, fn_s, fp_s, cum_s, i0, j0, Q, P, N, w_s, v_s, m_s, tid);
      __syncthreads();
      for (int i = tid; i < kTile * P; i += kThreads) {
        const int jj = i / P, p = i - jj * P;
        float acc = ap_s[jj * PP + p];
        for (int r = 0; r < kTile; ++r) acc += w_s[r * TP + jj] * vp_s[r * PP + p];
        ap_s[jj * PP + p] = acc;
      }
      for (int i = tid; i < kTile * N; i += kThreads) {
        const int jj = i / N, n = i - jj * N;
        float acc = an_s[jj * NP + n];
        for (int r = 0; r < kTile; ++r) acc += v_s[r * TP + jj] * vn_s[r * NP + n];
        an_s[jj * NP + n] = acc;
      }
      if (tid < kTile) {
        float acc = 0.f;
        for (int r = 0; r < kTile; ++r) acc += m_s[r * TP + tid];
        if (j0 + tid < Q) colm_s[j0 + tid] += acc;
      }
    }
    __syncthreads();
    // dx = dt du, dB a head's own, and x·du (x from the operand: u / dt
    // would divide by a zero dt)
    XT* dxb = dx + ((size_t)b * d.S * d.H + h) * P;
    for (int i = tid; i < kTile * P; i += kThreads) {
      const int jj = i / P, p = i - jj * P, q = j0 + jj;
      if (q < Q && s0 + q < d.S)
        dxb[((size_t)s0 + q) * d.H * P + p] = from_f32<XT>(dt_s[q] * ap_s[jj * PP + p]);
    }
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int jj = i / N, n = i - jj * N, q = j0 + jj;
      if (q < Q && s0 + q < d.S)
        db_part[(((size_t)b * d.S + s0 + q) * d.H + h) * N + n] = an_s[jj * NP + n];
    }
    for (int r = warp; r < kTile; r += kWarps) {
      const int q = j0 + r;
      float part = 0.f;
      if (q < Q && s0 + q < d.S)
        for (int p = lane; p < P; p += 32)
          part += to_f32(xb[(long long)(s0 + q) * st.x_s + p]) * ap_s[r * PP + p];
      part = warp_sum(part);
      if (lane == 0 && q < Q) xdu_s[q] = part;
    }
    __syncthreads();
  }

  // ---- dcum, da = its reverse prefix sum, ddt and the head's dA
  if (tid < 32) {  // T's share: Σ_j s_j + exp(T) Σ dh_out ∘ h_in
    float part = 0.f;
    for (int q = tid; q < Q; q += 32) part += s_s[q];
    part = warp_sum(part);
    if (tid == 0) red_s[0] = part + expf(total) * hdh;
  }
  __syncthreads();
  for (int q = tid; q < Q; q += kThreads)
    rowm_s[q] = rowm_s[q] - colm_s[q] + cterm_s[q] - s_s[q] + (q == Q - 1 ? red_s[0] : 0.f);
  __syncthreads();
  chunk_suffix_sum(rowm_s, Q, tid);
  __syncthreads();
  for (int q = tid; q < Q; q += kThreads)
    if (s0 + q < d.S) ddt[((size_t)b * d.S + s0 + q) * d.H + h] = xdu_s[q] + a * rowm_s[q];
  if (tid < 32) {
    float part = 0.f;
    for (int q = tid; q < Q; q += 32) part += dt_s[q] * rowm_s[q];
    part = warp_sum(part);
    if (tid == 0) da_part[(size_t)bc * d.H + h] = part;
  }
}

// Pass 4: dB and dC over the heads, in order, a thread an element.
template <typename BT>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce_kernel(
    const float* __restrict__ db_part, const float* __restrict__ dc_part, BT* __restrict__ dB,
    BT* __restrict__ dC, Dims d) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (size_t)d.B * d.S * d.N) return;
  const size_t row = e / d.N, n = e - row * d.N;
  const float* bp = db_part + row * d.H * d.N + n;
  const float* cp = dc_part + row * d.H * d.N + n;
  float sb = 0.f, sc = 0.f;
  for (int h = 0; h < d.H; ++h) {
    sb += bp[(size_t)h * d.N];
    sc += cp[(size_t)h * d.N];
  }
  dB[e] = from_f32<BT>(sb);
  dC[e] = from_f32<BT>(sc);
}

// dA over rows and chunks, in order, a thread a head.
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce_da_kernel(
    const float* __restrict__ da_part, float* __restrict__ dA, Dims d) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= d.H) return;
  float s = 0.f;
  for (int bc = 0; bc < d.B * d.C; ++bc) s += da_part[(size_t)bc * d.H + h];
  dA[h] = s;
}

size_t chunk_smem(int Q) { return sizeof(float) * (2 * (size_t)Q + kTile * (kOutP + kOutN)); }

template <typename XT, typename BT>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                   const void* dy, const void* dfinal, void* dx, void* ddt, void* dA, void* dB,
                   void* dC, void* workspace, const Dims& d, const Strides& st,
                   cudaStream_t stream) {
  const size_t BCH = (size_t)d.B * d.C * d.H;
  float* cum_ws = static_cast<float*>(workspace);
  float* states = cum_ws + BCH * d.Q;
  float* dstates = states + BCH * d.P * d.N;
  float* db_part = dstates + BCH * d.P * d.N;
  float* dc_part = db_part + (size_t)d.B * d.S * d.H * d.N;
  float* da_part = dc_part + (size_t)d.B * d.S * d.H * d.N;
  const auto* xp = static_cast<const XT*>(x);
  const auto* dyp = static_cast<const XT*>(dy);
  const auto* bp = static_cast<const BT*>(Bm);
  const auto* cp = static_cast<const BT*>(Cm);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* ap = static_cast<const float*>(A);

  const int n_tiles = (d.N + kOutN - 1) / kOutN;
  const int tiles = ((d.P + kOutP - 1) / kOutP) * n_tiles;
  const size_t smem1 = chunk_smem(d.Q);
  const size_t smem3 = sizeof(float) * grad_smem_floats(d.P, d.N, d.Q);
  if (smem1 > (size_t)kSmemLimit || smem3 > (size_t)kSmemLimit)
    return cudaErrorInvalidConfiguration;
  auto k1 = ssd_bwd_chunk_kernel<XT, BT>;
  auto k3 = ssd_bwd_grad_kernel<XT, BT>;
  cudaError_t err = cudaFuncSetAttribute(k1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return err;

  k1<<<dim3((unsigned)((size_t)tiles * 2 * d.B * d.C), d.H), kThreads, smem1, stream>>>(
      xp, dtp, ap, bp, cp, dyp, cum_ws, states, dstates, d, st, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t PN = (size_t)d.P * d.N;
  ssd_bwd_state_kernel<<<dim3((unsigned)((PN + kThreads - 1) / kThreads), d.H, d.B), kThreads,
                         0, stream>>>(cum_ws, states, dstates,
                                      static_cast<const float*>(dfinal), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  k3<<<dim3(d.B * d.C, d.H), kThreads, smem3, stream>>>(
      xp, dtp, ap, bp, cp, dyp, cum_ws, states, dstates, dfinal != nullptr,
      static_cast<XT*>(dx), static_cast<float*>(ddt), db_part, dc_part, da_part, d, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t elems = (size_t)d.B * d.S * d.N;
  ssd_bwd_reduce_kernel<BT><<<(unsigned)((elems + kThreads - 1) / kThreads), kThreads, 0,
                              stream>>>(db_part, dc_part, static_cast<BT*>(dB),
                                        static_cast<BT*>(dC), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_reduce_da_kernel<<<(d.H + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      da_part, static_cast<float*>(dA), d);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t dispatch_bc(int bc_dtype, const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* dy, const void* dfinal,
                        void* dx, void* ddt, void* dA, void* dB, void* dC, void* workspace,
                        const Dims& d, const Strides& st, cudaStream_t stream) {
  switch (bc_dtype) {
    case 0:
      return launch<XT, float>(x, dt, A, Bm, Cm, dy, dfinal, dx, ddt, dA, dB, dC, workspace, d,
                               st, stream);
    case 1:
      return launch<XT, __nv_bfloat16>(x, dt, A, Bm, Cm, dy, dfinal, dx, ddt, dA, dB, dC,
                                       workspace, d, st, stream);
    default:
      return cudaErrorInvalidValue;
  }
}


// ------------------------------------------------------------ tensor cores
typedef __nv_bfloat16 bf16;
constexpr int kTcChunkWarps = 8;  // chunk pass
constexpr int kTcChunkThreads = 32 * kTcChunkWarps;
constexpr int kTcChunkCols = 64;  // the widest column range of N a chunk-pass block covers
constexpr int kTcGradWarps = 8;   // the most warps of a gradient-pass block
constexpr int kTcDuCols = 64;     // columns of P a du accumulator holds
constexpr float kLog2e = 1.4426950408889634f;

// columns of N a chunk-pass block covers: the widest multiple of 16 that
// divides N, at most kTcChunkCols
__host__ __device__ inline int tc_chunk_cols(int N) {
  for (int w = kTcChunkCols; w > 16; w -= 16)
    if (N % w == 0) return w;
  return 16;
}

// a float4 of an f32 state into the hi and lo bf16 rows at `off`
__device__ __forceinline__ void stage_split4(const float4 v, bf16* hi_s, bf16* lo_s, int off) {
  __nv_bfloat162 h0, l0, h1, l1;
  split_bf16(v.x, v.y, h0, l0);
  split_bf16(v.z, v.w, h1, l1);
  __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(hi_s + off);
  __nv_bfloat162* lp = reinterpret_cast<__nv_bfloat162*>(lo_s + off);
  hp[0] = h0;
  hp[1] = h1;
  lp[0] = l0;
  lp[1] = l1;
}

__device__ __forceinline__ float2 bf2_at(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// the sum of a value over the four lanes of a quad (the lanes that hold one
// accumulator row), the same tree on every lane
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Pass 1 on tensor cores, grid (N / nw, H, B x C x 2): mode 0 (even z) the
// chunk's own state xᵀ·(B ∘ dt·exp(T - cum)), mode 1 its share of the
// state's gradient dyᵀ·(C ∘ exp(cum)), columns [n0, n0 + nw) of the [P, N]
// slot of (row, chunk, head); mode 0's first range also writes cum. The
// forward's chunk pass with other row weights: x or dy as they come (A
// fragments from `ldmatrix.trans`), the f32-weighted B or C rows as hi + lo
// bf16 pairs. The last chunk's state and the first chunk's share are never
// read (pass 2 carries neither on), so those blocks compute no product.
__global__ void __launch_bounds__(kTcChunkThreads) ssd_bwd_chunk_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
    float* __restrict__ cum_ws, float* __restrict__ states, float* __restrict__ dstates, Dims d,
    Strides st, int nw) {
  const int h = blockIdx.y, mode = blockIdx.z & 1, bc = blockIdx.z >> 1;
  const int b = bc / d.C, c = bc % d.C;
  const bool writes_cum = mode == 0 && blockIdx.x == 0;
  const bool product = mode == 0 ? c < d.C - 1 : c > 0;
  if (!product && !writes_cum) return;
  const int Q = d.Q, P = d.P, N = d.N, n0 = blockIdx.x * nw;
  const int XR = P + 8, BR = nw + 8;  // padded shared rows, elements
  const int s0 = c * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* x_s = reinterpret_cast<bf16*>(smem_raw);            // [Q][XR]: x or dy
  bf16* bhi_s = x_s + Q * XR;                               // [Q][BR]: B or C, then hi
  bf16* blo_s = bhi_s + Q * BR;                             // [Q][BR]: lo
  float* cum_s = reinterpret_cast<float*>(blo_s + Q * BR);  // [Q]
  float* w_s = cum_s + Q;                                   // [Q]: dt, then the row weights

  if (product) {
    const bf16* src = mode == 0 ? x + b * st.x_b + h * st.x_h : dy + b * st.dy_b + h * st.dy_h;
    const long long src_s = mode == 0 ? st.x_s : st.dy_s;
    const bf16* wsrc = mode == 0 ? Bm + b * st.b_b + n0 : Cm + b * st.c_b + n0;
    const long long wsrc_s = mode == 0 ? st.b_s : st.c_s;
    for (int i = tid; i < Q * (P / 8); i += kTcChunkThreads) {
      const int r = i / (P / 8), col = (i - r * (P / 8)) * 8;
      const bool ok = s0 + r < d.S;
      cp_async16(x_s + r * XR + col, ok ? src + (long long)(s0 + r) * src_s + col : src, ok);
    }
    for (int i = tid; i < Q * (nw / 8); i += kTcChunkThreads) {
      const int r = i / (nw / 8), col = (i - r * (nw / 8)) * 8;
      const bool ok = s0 + r < d.S;
      cp_async16(bhi_s + r * BR + col, ok ? wsrc + (long long)(s0 + r) * wsrc_s + col : wsrc,
                 ok);
    }
    cp_async_commit();
  }
  const float* dtb = dt + b * st.dt_b + h;
  for (int q = tid; q < Q; q += kTcChunkThreads)
    w_s[q] = s0 + q < d.S ? dtb[(long long)(s0 + q) * st.dt_s] : 0.f;
  __syncthreads();
  chunk_cumsum(w_s, A[h], cum_s, Q, tid);
  __syncthreads();
  if (writes_cum) {
    float* cw = cum_ws + ((size_t)bc * d.H + h) * Q;
    for (int q = tid; q < Q; q += kTcChunkThreads) cw[q] = cum_s[q];
  }
  if (!product) return;
  const float total = cum_s[Q - 1];
  for (int q = tid; q < Q; q += kTcChunkThreads)
    w_s[q] = mode == 0 ? w_s[q] * expf(total - cum_s[q]) : expf(cum_s[q]);
  cp_async_wait<0>();
  __syncthreads();
  // the weighted rows as hi + lo bf16 pairs, hi in place
  for (int i = tid; i < Q * (nw / 2); i += kTcChunkThreads) {
    const int r = i / (nw / 2), col = (i - r * (nw / 2)) * 2;
    __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(bhi_s + r * BR + col);
    const float2 v = __bfloat1622float2(*hp);
    const float w = w_s[r];
    __nv_bfloat162 hi, lo;
    split_bf16(v.x * w, v.y * w, hi, lo);
    *hp = hi;
    *reinterpret_cast<__nv_bfloat162*>(blo_s + r * BR + col) = lo;
  }
  __syncthreads();

  // out[p, n] = Σ_q src[q, p] w[q] B[q, n]: a warp takes 16 rows of P by up
  // to 32 columns at a time (at mamba2's widths every warp has an item)
  float* out = (mode == 0 ? states : dstates) + ((size_t)bc * d.H + h) * P * N;
  const int g = lane >> 2, t4 = lane & 3;
  const int n_tiles = (nw + 31) / 32;
  for (int item = warp; item < (P / 16) * n_tiles; item += kTcChunkWarps) {
    const int pt = item / n_tiles, nb = (item - pt * n_tiles) * 32;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int k = 0; k < Q; k += 16) {
      uint32_t af[4];
      ldmatrix_x4_trans(af, x_s + (k + (lane & 7) + ((lane >> 4) << 3)) * XR + pt * 16 +
                                ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (nb + 16 * j < nw) {
          const int off =
              (k + (lane & 7) + ((lane >> 3) & 1) * 8) * BR + nb + 16 * j + (lane >> 4) * 8;
          uint32_t bh[4], bl[4];
          ldmatrix_x4_trans(bh, bhi_s + off);
          ldmatrix_x4_trans(bl, blo_s + off);
          mma_bf16(acc[2 * j], af, bh[0], bh[1]);
          mma_bf16(acc[2 * j + 1], af, bh[2], bh[3]);
          mma_bf16(acc[2 * j], af, bl[0], bl[1]);
          mma_bf16(acc[2 * j + 1], af, bl[2], bl[3]);
        }
      }
    }
    const int p = pt * 16 + g;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (nb + 8 * j < nw) {
        const int n = n0 + nb + 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(out + (size_t)p * N + n) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(out + (size_t)(p + 8) * N + n) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
}

__device__ __forceinline__ float4 carry_on(float4 carry, float decay, float4 v) {
  return make_float4(carry.x * decay + v.x, carry.y * decay + v.y, carry.z * decay + v.z,
                     carry.w * decay + v.w);
}

// Pass 2 on the tensor cores' route, a thread per 4 state elements of a
// (row, head), serial over chunks: slot c of `states` becomes the state
// before chunk c and slot c of `dstates` the gradient of the state after
// chunk c, as in ssd_bwd_state_kernel, in float4. The last chunk's own
// state and the first chunk's share of the gradient are not read (pass 1
// did not compute them). Bound by its bytes: each thread loads the slots of
// kStateAhead chunks before it stores the first, so that many loads are in
// flight, not one.
constexpr int kStateAhead = 4;
__global__ void __launch_bounds__(kThreads) ssd_bwd_state_tc_kernel(
    const float* __restrict__ cum_ws, float* __restrict__ states, float* __restrict__ dstates,
    const float* __restrict__ dfinal, Dims d) {
  const size_t PN4 = (size_t)d.P * d.N / 4;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN4) return;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  auto slot = [&](int c) { return ((size_t)b * d.C + c) * d.H + h; };
  float4* s4 = reinterpret_cast<float4*>(states);
  float4* ds4 = reinterpret_cast<float4*>(dstates);
  float4 carry = zero;
  for (int c0 = 0; c0 < d.C; c0 += kStateAhead) {
    float4 v[kStateAhead];
    float decay[kStateAhead];
#pragma unroll
    for (int k = 0; k < kStateAhead; ++k) {
      const int c = c0 + k;
      const bool read = c < d.C - 1;
      v[k] = read ? s4[slot(c) * PN4 + e] : zero;
      decay[k] = read ? expf(cum_ws[slot(c) * d.Q + d.Q - 1]) : 1.f;
    }
#pragma unroll
    for (int k = 0; k < kStateAhead; ++k) {
      if (c0 + k < d.C) {
        s4[slot(c0 + k) * PN4 + e] = carry;
        carry = carry_on(carry, decay[k], v[k]);
      }
    }
  }
  float4 dcarry = dfinal != nullptr
                      ? reinterpret_cast<const float4*>(dfinal)[((size_t)b * d.H + h) * PN4 + e]
                      : zero;
  for (int c0 = d.C - 1; c0 >= 0; c0 -= kStateAhead) {
    float4 v[kStateAhead];
    float decay[kStateAhead];
#pragma unroll
    for (int k = 0; k < kStateAhead; ++k) {
      const int c = c0 - k;
      const bool read = c > 0;
      v[k] = read ? ds4[slot(c) * PN4 + e] : zero;
      decay[k] = read ? expf(cum_ws[slot(c) * d.Q + d.Q - 1]) : 1.f;
    }
#pragma unroll
    for (int k = 0; k < kStateAhead; ++k) {
      if (c0 - k >= 0) {
        ds4[slot(c0 - k) * PN4 + e] = dcarry;
        dcarry = carry_on(dcarry, decay[k], v[k]);
      }
    }
  }
}

// Pass 3 on tensor cores, one block a (row x chunk, head): the chunk's C, B,
// x and dy rows in shared memory (16-byte `cp.async`, zero past S), and the
// state that a sweep's state term reads (h_in, then dh_out) as hi + lo bf16
// rows. Warps of 16 rows; each owns the same row tiles in both sweeps, in
// snake order, so every warp covers as many (query, key) tile pairs.
//   Sweep A holds query rows i and walks the key tiles j <= i: G = C_i·B_jᵀ
// over N and D' = dy_i·x_jᵀ over P from bf16 fragments (exact products, f32
// sums), then in registers V = D'·dt_j·L (L = exp(cum_i - cum_j), masked
// before the exp) and the row sums of M = V∘G; dC += V·B_j with V as a hi +
// lo A fragment straight from the accumulators. Its state term dy_i·h_in,
// scaled by exp(cum_i), comes first, and C_i·(that term) gives its dcum
// share.
//   Sweep B holds key rows j and walks the query tiles i >= j, with the
// scores transposed (Gᵀ = B_j·C_iᵀ, D'ᵀ = x_j·dy_iᵀ) so a warp's rows are its
// keys: Wᵀ = Gᵀ·L and Vᵀ = D'ᵀ·dt_j·L, the row sums of Mᵀ, du += Wᵀ·dy_i and
// dB += Vᵀ·C_i. Its state terms come first: du = exp(T - cum_j) B_j·dh_outᵀ
// (and u_j·du, its dcum share) and dB = dt_j exp(T - cum_j) x_j·dh_out, so
// u = dt·x is never an operand: dt enters as an f32 scale.
//   dC and dB accumulate WN columns at a time and du 64 (more columns run
// the sweep again), which keeps a thread's registers under 255. Then the
// tail: dcum, its reverse prefix sum, ddt, dx = dt·du (x·du reads x, never
// u / dt) and the head's share of dA. kP and kN, where not 0, fix P and N
// at compile time (mamba2's and zamba2's widths), so the products' loops
// unroll and the row strides are constants; 0 reads them from `d`.
template <int WN, int kP, int kN>
__global__ void __launch_bounds__(32 * kTcGradWarps) ssd_bwd_grad_tc_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
    const float* __restrict__ cum_ws, const float* __restrict__ states,
    const float* __restrict__ dstates, int has_dfinal, bf16* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ db_part, float* __restrict__ dc_part,
    float* __restrict__ da_part, Dims d, Strides st) {
  constexpr int TN = WN / 8;         // 8-column tiles of a dC or dB accumulator
  constexpr int TP = kTcDuCols / 8;  // of a du accumulator
  const int bc = blockIdx.x, b = bc / d.C, c = bc % d.C, h = blockIdx.y;
  const int Q = d.Q, P = kP > 0 ? kP : d.P, N = kN > 0 ? kN : d.N, s0 = c * Q;
  const int NR = N + 8, PR = P + 8;  // padded shared rows, elements
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, warps = blockDim.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t PN = (size_t)P * N;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);  // [Q][NR]
  bf16* b_s = c_s + Q * NR;                       // [Q][NR]
  bf16* x_s = b_s + Q * NR;                       // [Q][PR]
  bf16* dy_s = x_s + Q * PR;                      // [Q][PR]
  bf16* shi_s = dy_s + Q * PR;                    // [P][NR]: h_in, then dh_out, hi
  bf16* slo_s = shi_s + P * NR;                   // [P][NR]: lo
  float* cum2_s = reinterpret_cast<float*>(slo_s + P * NR);  // [Q]: cum·log2(e)
  float* dt_s = cum2_s + Q;                                  // [Q]
  float* rowm_s = dt_s + Q;                                  // [Q]: Σ_j M_ij
  float* colm_s = rowm_s + Q;                                // [Q]: Σ_i M_ij
  float* cterm_s = colm_s + Q;  // [Q]: C_i·exp(cum_i) h_inᵀ dy_i
  float* s_s = cterm_s + Q;     // [Q]: u_j·exp(T - cum_j) dh_out B_j
  float* xdu_s = s_s + Q;       // [Q]: x_j·du_j
  float* red_s = xdu_s + Q;     // [kTcGradWarps]

  const bf16* xb = x + b * st.x_b + h * st.x_h;
  const bf16* dyb = dy + b * st.dy_b + h * st.dy_h;
  const bf16* Bb = Bm + b * st.b_b;
  const bf16* Cb = Cm + b * st.c_b;
  for (int i = tid; i < Q * (N / 8); i += blockDim.x) {
    const int r = i / (N / 8), col = (i - r * (N / 8)) * 8;
    const bool ok = s0 + r < d.S;
    const long long pos = s0 + r;
    cp_async16(c_s + r * NR + col, ok ? Cb + pos * st.c_s + col : Cb, ok);
    cp_async16(b_s + r * NR + col, ok ? Bb + pos * st.b_s + col : Bb, ok);
  }
  for (int i = tid; i < Q * (P / 8); i += blockDim.x) {
    const int r = i / (P / 8), col = (i - r * (P / 8)) * 8;
    const bool ok = s0 + r < d.S;
    const long long pos = s0 + r;
    cp_async16(x_s + r * PR + col, ok ? xb + pos * st.x_s + col : xb, ok);
    cp_async16(dy_s + r * PR + col, ok ? dyb + pos * st.dy_s + col : dyb, ok);
  }
  cp_async_commit();
  const float* cw = cum_ws + ((size_t)bc * d.H + h) * Q;
  const float* dtb = dt + b * st.dt_b + h;
  for (int q = tid; q < Q; q += blockDim.x) {
    cum2_s[q] = cw[q] * kLog2e;
    dt_s[q] = s0 + q < d.S ? dtb[(long long)(s0 + q) * st.dt_s] : 0.f;
    rowm_s[q] = colm_s[q] = cterm_s[q] = s_s[q] = xdu_s[q] = 0.f;
  }
  const bool has_h = c > 0;
  const bool has_dh = c < d.C - 1 || has_dfinal;
  const float* h_in = states + ((size_t)bc * d.H + h) * PN;
  const float* dh_out = dstates + ((size_t)bc * d.H + h) * PN;
  // a [P][N] f32 state as hi + lo rows; returns this thread's share of
  // Σ state ∘ other (other: null for none), in a fixed order
  auto stage = [&](const float* src, const float* other) {
    float part = 0.f;
    for (int i = tid; i < P * (N / 4); i += blockDim.x) {
      const int r = i / (N / 4), col = (i - r * (N / 4)) * 4;
      const float4 v = reinterpret_cast<const float4*>(src)[i];
      if (other != nullptr) {
        const float4 o = reinterpret_cast<const float4*>(other)[i];
        part += v.x * o.x + v.y * o.y + v.z * o.z + v.w * o.w;
      }
      stage_split4(v, shi_s, slo_s, r * NR + col);
    }
    return part;
  };
  if (has_h) stage(h_in, nullptr);
  cp_async_wait<0>();
  __syncthreads();

  const int per_warp = (Q / 16) / warps;
  auto row_tile = [&](int k) { return 16 * (k * warps + ((k & 1) ? warps - 1 - warp : warp)); };
  const int n_passes = (N + WN - 1) / WN, p_passes = (P + kTcDuCols - 1) / kTcDuCols;
  // lane offsets of `ldmatrix` fragments: A from [row][k] rows, B from [n][k]
  // rows, B from [k][n] rows (`.trans`)
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + ((lane >> 4) << 3), b_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_col = (lane >> 4) * 8;

  // ---- sweep A: a warp's query tiles, the key tiles at or below them
  for (int pa = 0; pa < n_passes; ++pa) {
    const int n0 = pa * WN;
    for (int k = 0; k < per_warp; ++k) {
      const int i0 = row_tile(k);
      if (s0 + i0 >= d.S) continue;
      const int r0 = i0 + g, r1 = r0 + 8;
      const float ci0 = cum2_s[r0], ci1 = cum2_s[r1];
      float acc[TN][4];
#pragma unroll
      for (int t = 0; t < TN; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
      float ct0 = 0.f, ct1 = 0.f;
      if (has_h) {  // exp(cum_i) dy_i·h_in, and C_i·(it) toward dcum_i
        for (int kp = 0; kp < P; kp += 16) {
          uint32_t af[4];
          ldmatrix_x4(af, dy_s + (i0 + a_row) * PR + kp + a_col);
#pragma unroll
          for (int dp = 0; dp < TN / 2; ++dp) {
            if (n0 + 16 * dp < N) {
              const int off = (kp + t_row) * NR + n0 + 16 * dp + t_col;
              uint32_t bh[4], bl[4];
              ldmatrix_x4_trans(bh, shi_s + off);
              ldmatrix_x4_trans(bl, slo_s + off);
              mma_bf16(acc[2 * dp], af, bh[0], bh[1]);
              mma_bf16(acc[2 * dp + 1], af, bh[2], bh[3]);
              mma_bf16(acc[2 * dp], af, bl[0], bl[1]);
              mma_bf16(acc[2 * dp + 1], af, bl[2], bl[3]);
            }
          }
        }
        const float e0 = exp2f(ci0), e1 = exp2f(ci1);
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          if (n0 + 8 * t < N) {
            const int n = n0 + 8 * t + 2 * t4;
            acc[t][0] *= e0;
            acc[t][1] *= e0;
            acc[t][2] *= e1;
            acc[t][3] *= e1;
            const float2 c0 = bf2_at(c_s + r0 * NR + n), c1 = bf2_at(c_s + r1 * NR + n);
            ct0 += c0.x * acc[t][0] + c0.y * acc[t][1];
            ct1 += c1.x * acc[t][2] + c1.y * acc[t][3];
          }
        }
      }
      float rm0 = 0.f, rm1 = 0.f;
      for (int j0 = 0; j0 <= i0; j0 += 16) {
        float G[2][4], D[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) G[t][e] = D[t][e] = 0.f;
#pragma unroll
        for (int kn = 0; kn < N; kn += 16) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, c_s + (i0 + a_row) * NR + kn + a_col);
          ldmatrix_x4(bf, b_s + (j0 + b_row) * NR + kn + b_col);
          mma_bf16(G[0], af, bf[0], bf[1]);
          mma_bf16(G[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int kp = 0; kp < P; kp += 16) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, dy_s + (i0 + a_row) * PR + kp + a_col);
          ldmatrix_x4(bf, x_s + (j0 + b_row) * PR + kp + b_col);
          mma_bf16(D[0], af, bf[0], bf[1]);
          mma_bf16(D[1], af, bf[2], bf[3]);
        }
        // V = D'·dt_j·L, zero where j > i (masked before the exp); M = V·G
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = j0 + 8 * t + 2 * t4 + e;
            const float cj = cum2_s[j], dj = dt_s[j];
            const float l0 = j <= r0 ? exp2f(ci0 - cj) : 0.f;
            const float l1 = j <= r1 ? exp2f(ci1 - cj) : 0.f;
            const float v0 = D[t][e] * dj * l0, v1 = D[t][2 + e] * dj * l1;
            rm0 += v0 * G[t][e];
            rm1 += v1 * G[t][2 + e];
            D[t][e] = v0;
            D[t][2 + e] = v1;
          }
        uint32_t vh[4], vl[4];
        split_pack(D[0][0], D[0][1], vh[0], vl[0]);
        split_pack(D[0][2], D[0][3], vh[1], vl[1]);
        split_pack(D[1][0], D[1][1], vh[2], vl[2]);
        split_pack(D[1][2], D[1][3], vh[3], vl[3]);
        // dC += V·B_j: B_j's rows are the k of this step
#pragma unroll
        for (int dp = 0; dp < TN / 2; ++dp) {
          if (n0 + 16 * dp < N) {
            uint32_t bf[4];
            ldmatrix_x4_trans(bf, b_s + (j0 + t_row) * NR + n0 + 16 * dp + t_col);
            mma_bf16(acc[2 * dp], vh, bf[0], bf[1]);
            mma_bf16(acc[2 * dp + 1], vh, bf[2], bf[3]);
            mma_bf16(acc[2 * dp], vl, bf[0], bf[1]);
            mma_bf16(acc[2 * dp + 1], vl, bf[2], bf[3]);
          }
        }
      }
      rm0 = quad_sum(rm0);
      rm1 = quad_sum(rm1);
      ct0 = quad_sum(ct0);
      ct1 = quad_sum(ct1);
      if (t4 == 0) {
        if (pa == 0) {
          rowm_s[r0] = rm0;
          rowm_s[r1] = rm1;
        }
        cterm_s[r0] += ct0;
        cterm_s[r1] += ct1;
      }
      float* dcb = dc_part + (((size_t)b * d.S + s0) * d.H + h) * N;
      const size_t row = (size_t)d.H * N;
#pragma unroll
      for (int t = 0; t < TN; ++t) {
        if (n0 + 8 * t < N) {
          const int n = n0 + 8 * t + 2 * t4;
          if (s0 + r0 < d.S)
            *reinterpret_cast<float2*>(dcb + r0 * row + n) = make_float2(acc[t][0], acc[t][1]);
          if (s0 + r1 < d.S)
            *reinterpret_cast<float2*>(dcb + r1 * row + n) = make_float2(acc[t][2], acc[t][3]);
        }
      }
    }
  }

  // ---- sweep B: a warp's key tiles, the query tiles at or after them
  __syncthreads();  // every warp is done with h_in
  float hdh = 0.f;  // Σ dh_out ∘ h_in, in a fixed order
  {
    float part = has_dh ? stage(dh_out, has_h ? h_in : nullptr) : 0.f;
    part = warp_sum(part);
    if (lane == 0) red_s[warp] = part;
    __syncthreads();
    for (int w = 0; w < warps; ++w) hdh += red_s[w];
  }
  const float T2 = cum2_s[Q - 1];
  for (int pb = 0; pb < max(n_passes, p_passes); ++pb) {
    const bool with_du = pb < p_passes, with_db = pb < n_passes;
    const int p0 = pb * kTcDuCols, n0 = pb * WN;
    for (int k = 0; k < per_warp; ++k) {
      const int j0 = row_tile(k);
      if (s0 + j0 >= d.S) continue;
      const int r0 = j0 + g, r1 = r0 + 8;
      const float cj0 = cum2_s[r0], cj1 = cum2_s[r1];
      const float dj0 = dt_s[r0], dj1 = dt_s[r1];
      float du[TP][4], db[TN][4];
#pragma unroll
      for (int t = 0; t < TP; ++t) du[t][0] = du[t][1] = du[t][2] = du[t][3] = 0.f;
#pragma unroll
      for (int t = 0; t < TN; ++t) db[t][0] = db[t][1] = db[t][2] = db[t][3] = 0.f;
      float sp0 = 0.f, sp1 = 0.f;
      if (has_dh) {
        const float te0 = exp2f(T2 - cj0), te1 = exp2f(T2 - cj1);
        if (with_du) {  // exp(T - cum_j) B_j·dh_outᵀ, and u_j·(it) toward dcum_j
          for (int kn = 0; kn < N; kn += 16) {
            uint32_t af[4];
            ldmatrix_x4(af, b_s + (j0 + a_row) * NR + kn + a_col);
#pragma unroll
            for (int dp = 0; dp < TP / 2; ++dp) {
              if (p0 + 16 * dp < P) {
                const int off = (p0 + 16 * dp + b_row) * NR + kn + b_col;
                uint32_t bh[4], bl[4];
                ldmatrix_x4(bh, shi_s + off);
                ldmatrix_x4(bl, slo_s + off);
                mma_bf16(du[2 * dp], af, bh[0], bh[1]);
                mma_bf16(du[2 * dp + 1], af, bh[2], bh[3]);
                mma_bf16(du[2 * dp], af, bl[0], bl[1]);
                mma_bf16(du[2 * dp + 1], af, bl[2], bl[3]);
              }
            }
          }
#pragma unroll
          for (int t = 0; t < TP; ++t) {
            if (p0 + 8 * t < P) {
              const int p = p0 + 8 * t + 2 * t4;
              du[t][0] *= te0;
              du[t][1] *= te0;
              du[t][2] *= te1;
              du[t][3] *= te1;
              const float2 x0 = bf2_at(x_s + r0 * PR + p), x1 = bf2_at(x_s + r1 * PR + p);
              sp0 += x0.x * du[t][0] + x0.y * du[t][1];
              sp1 += x1.x * du[t][2] + x1.y * du[t][3];
            }
          }
          sp0 *= dj0;
          sp1 *= dj1;
        }
        if (with_db) {  // dt_j exp(T - cum_j) x_j·dh_out
          for (int kp = 0; kp < P; kp += 16) {
            uint32_t af[4];
            ldmatrix_x4(af, x_s + (j0 + a_row) * PR + kp + a_col);
#pragma unroll
            for (int dp = 0; dp < TN / 2; ++dp) {
              if (n0 + 16 * dp < N) {
                const int off = (kp + t_row) * NR + n0 + 16 * dp + t_col;
                uint32_t bh[4], bl[4];
                ldmatrix_x4_trans(bh, shi_s + off);
                ldmatrix_x4_trans(bl, slo_s + off);
                mma_bf16(db[2 * dp], af, bh[0], bh[1]);
                mma_bf16(db[2 * dp + 1], af, bh[2], bh[3]);
                mma_bf16(db[2 * dp], af, bl[0], bl[1]);
                mma_bf16(db[2 * dp + 1], af, bl[2], bl[3]);
              }
            }
          }
          const float f0 = te0 * dj0, f1 = te1 * dj1;
#pragma unroll
          for (int t = 0; t < TN; ++t) {
            db[t][0] *= f0;
            db[t][1] *= f0;
            db[t][2] *= f1;
            db[t][3] *= f1;
          }
        }
      }
      float cm0 = 0.f, cm1 = 0.f;
      for (int i0 = j0; i0 < Q && s0 + i0 < d.S; i0 += 16) {
        float G[2][4], D[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) G[t][e] = D[t][e] = 0.f;
#pragma unroll
        for (int kn = 0; kn < N; kn += 16) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, b_s + (j0 + a_row) * NR + kn + a_col);
          ldmatrix_x4(bf, c_s + (i0 + b_row) * NR + kn + b_col);
          mma_bf16(G[0], af, bf[0], bf[1]);
          mma_bf16(G[1], af, bf[2], bf[3]);
        }
#pragma unroll
        for (int kp = 0; kp < P; kp += 16) {
          uint32_t af[4], bf[4];
          ldmatrix_x4(af, x_s + (j0 + a_row) * PR + kp + a_col);
          ldmatrix_x4(bf, dy_s + (i0 + b_row) * PR + kp + b_col);
          mma_bf16(D[0], af, bf[0], bf[1]);
          mma_bf16(D[1], af, bf[2], bf[3]);
        }
        // Wᵀ = Gᵀ·L and Vᵀ = D'ᵀ·dt_j·L (rows: keys j; columns: queries i),
        // zero where i < j; the row sums of Mᵀ = Vᵀ∘Gᵀ
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = i0 + 8 * t + 2 * t4 + e;
            const float ci = cum2_s[i];
            const float l0 = i >= r0 ? exp2f(ci - cj0) : 0.f;
            const float l1 = i >= r1 ? exp2f(ci - cj1) : 0.f;
            const float v0 = D[t][e] * dj0 * l0, v1 = D[t][2 + e] * dj1 * l1;
            cm0 += v0 * G[t][e];
            cm1 += v1 * G[t][2 + e];
            G[t][e] *= l0;
            G[t][2 + e] *= l1;
            D[t][e] = v0;
            D[t][2 + e] = v1;
          }
        uint32_t wh[4], wl[4], vh[4], vl[4];
        split_pack(G[0][0], G[0][1], wh[0], wl[0]);
        split_pack(G[0][2], G[0][3], wh[1], wl[1]);
        split_pack(G[1][0], G[1][1], wh[2], wl[2]);
        split_pack(G[1][2], G[1][3], wh[3], wl[3]);
        split_pack(D[0][0], D[0][1], vh[0], vl[0]);
        split_pack(D[0][2], D[0][3], vh[1], vl[1]);
        split_pack(D[1][0], D[1][1], vh[2], vl[2]);
        split_pack(D[1][2], D[1][3], vh[3], vl[3]);
        if (with_du) {  // du += Wᵀ·dy_i
#pragma unroll
          for (int dp = 0; dp < TP / 2; ++dp) {
            if (p0 + 16 * dp < P) {
              uint32_t bf[4];
              ldmatrix_x4_trans(bf, dy_s + (i0 + t_row) * PR + p0 + 16 * dp + t_col);
              mma_bf16(du[2 * dp], wh, bf[0], bf[1]);
              mma_bf16(du[2 * dp + 1], wh, bf[2], bf[3]);
              mma_bf16(du[2 * dp], wl, bf[0], bf[1]);
              mma_bf16(du[2 * dp + 1], wl, bf[2], bf[3]);
            }
          }
        }
        if (with_db) {  // dB += Vᵀ·C_i
#pragma unroll
          for (int dp = 0; dp < TN / 2; ++dp) {
            if (n0 + 16 * dp < N) {
              uint32_t bf[4];
              ldmatrix_x4_trans(bf, c_s + (i0 + t_row) * NR + n0 + 16 * dp + t_col);
              mma_bf16(db[2 * dp], vh, bf[0], bf[1]);
              mma_bf16(db[2 * dp + 1], vh, bf[2], bf[3]);
              mma_bf16(db[2 * dp], vl, bf[0], bf[1]);
              mma_bf16(db[2 * dp + 1], vl, bf[2], bf[3]);
            }
          }
        }
      }
      cm0 = quad_sum(cm0);
      cm1 = quad_sum(cm1);
      sp0 = quad_sum(sp0);
      sp1 = quad_sum(sp1);
      float xd0 = 0.f, xd1 = 0.f;
      if (with_du) {  // dx = dt du, and x·du toward ddt
        bf16* dxb = dx + (((size_t)b * d.S + s0) * d.H + h) * P;
        const size_t row = (size_t)d.H * P;
#pragma unroll
        for (int t = 0; t < TP; ++t) {
          if (p0 + 8 * t < P) {
            const int p = p0 + 8 * t + 2 * t4;
            const float2 x0 = bf2_at(x_s + r0 * PR + p), x1 = bf2_at(x_s + r1 * PR + p);
            xd0 += x0.x * du[t][0] + x0.y * du[t][1];
            xd1 += x1.x * du[t][2] + x1.y * du[t][3];
            if (s0 + r0 < d.S)
              *reinterpret_cast<__nv_bfloat162*>(dxb + r0 * row + p) =
                  __floats2bfloat162_rn(dj0 * du[t][0], dj0 * du[t][1]);
            if (s0 + r1 < d.S)
              *reinterpret_cast<__nv_bfloat162*>(dxb + r1 * row + p) =
                  __floats2bfloat162_rn(dj1 * du[t][2], dj1 * du[t][3]);
          }
        }
        xd0 = quad_sum(xd0);
        xd1 = quad_sum(xd1);
      }
      if (t4 == 0) {
        if (pb == 0) {
          colm_s[r0] = cm0;
          colm_s[r1] = cm1;
        }
        if (with_du) {
          s_s[r0] += sp0;
          s_s[r1] += sp1;
          xdu_s[r0] += xd0;
          xdu_s[r1] += xd1;
        }
      }
      if (with_db) {
        float* dbb = db_part + (((size_t)b * d.S + s0) * d.H + h) * N;
        const size_t row = (size_t)d.H * N;
#pragma unroll
        for (int t = 0; t < TN; ++t) {
          if (n0 + 8 * t < N) {
            const int n = n0 + 8 * t + 2 * t4;
            if (s0 + r0 < d.S)
              *reinterpret_cast<float2*>(dbb + r0 * row + n) = make_float2(db[t][0], db[t][1]);
            if (s0 + r1 < d.S)
              *reinterpret_cast<float2*>(dbb + r1 * row + n) = make_float2(db[t][2], db[t][3]);
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- dcum, da = its reverse prefix sum, ddt and the head's dA
  if (tid < 32) {  // T's share: Σ_j s_j + exp(T) Σ dh_out ∘ h_in
    float part = 0.f;
    for (int q = tid; q < Q; q += 32) part += s_s[q];
    part = warp_sum(part);
    if (tid == 0) red_s[0] = part + exp2f(T2) * hdh;
  }
  __syncthreads();
  for (int q = tid; q < Q; q += blockDim.x)
    rowm_s[q] = rowm_s[q] - colm_s[q] + cterm_s[q] - s_s[q] + (q == Q - 1 ? red_s[0] : 0.f);
  __syncthreads();
  chunk_suffix_sum(rowm_s, Q, tid);
  __syncthreads();
  const float a = A[h];
  for (int q = tid; q < Q; q += blockDim.x)
    if (s0 + q < d.S) ddt[((size_t)b * d.S + s0 + q) * d.H + h] = xdu_s[q] + a * rowm_s[q];
  if (tid < 32) {
    float part = 0.f;
    for (int q = tid; q < Q; q += 32) part += dt_s[q] * rowm_s[q];
    part = warp_sum(part);
    if (tid == 0) da_part[(size_t)bc * d.H + h] = part;
  }
}

size_t tc_chunk_smem(int P, int Q, int nw) {
  return 2 * ((size_t)Q * (P + 8) + 2 * (size_t)Q * (nw + 8)) + 8 * (size_t)Q;
}
size_t tc_grad_smem(int P, int N, int Q) {
  const size_t NR = N + 8, PR = P + 8;
  return 2 * (2 * Q * NR + 2 * Q * PR + 2 * P * NR) + 4 * (7 * (size_t)Q + kTcGradWarps);
}
size_t tc_smem(int P, int N, int Q) {
  return std::max(tc_chunk_smem(P, Q, tc_chunk_cols(N)), tc_grad_smem(P, N, Q));
}

cudaError_t launch_tc(const void* x, const void* dt, const void* A, const void* Bm,
                      const void* Cm, const void* dy, const void* dfinal, void* dx, void* ddt,
                      void* dA, void* dB, void* dC, void* workspace, const Dims& d,
                      const Strides& st, cudaStream_t stream) {
  if (d.P % 16 || d.N % 16 || d.Q % 64 || d.P > 256 || d.N > 256 || d.Q > 256)
    return cudaErrorInvalidValue;
  const int nw = tc_chunk_cols(d.N);
  const size_t smem1 = tc_chunk_smem(d.P, d.Q, nw), smem3 = tc_grad_smem(d.P, d.N, d.Q);
  if (std::max(smem1, smem3) > (size_t)kSmemLimit) return cudaErrorInvalidConfiguration;
  const size_t BCH = (size_t)d.B * d.C * d.H;
  float* cum_ws = static_cast<float*>(workspace);
  float* states = cum_ws + BCH * d.Q;
  float* dstates = states + BCH * d.P * d.N;
  float* db_part = dstates + BCH * d.P * d.N;
  float* dc_part = db_part + (size_t)d.B * d.S * d.H * d.N;
  float* da_part = dc_part + (size_t)d.B * d.S * d.H * d.N;
  const auto* xp = static_cast<const bf16*>(x);
  const auto* dyp = static_cast<const bf16*>(dy);
  const auto* bp = static_cast<const bf16*>(Bm);
  const auto* cp = static_cast<const bf16*>(Cm);
  const auto* dtp = static_cast<const float*>(dt);
  const auto* ap = static_cast<const float*>(A);

  auto k3 = d.P == 64 && d.N == 128  ? &ssd_bwd_grad_tc_kernel<128, 64, 128>
            : d.P == 64 && d.N == 64 ? &ssd_bwd_grad_tc_kernel<64, 64, 64>
            : d.N <= 64              ? &ssd_bwd_grad_tc_kernel<64, 0, 0>
                                     : &ssd_bwd_grad_tc_kernel<128, 0, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_chunk_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(k3, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem3);
  if (err != cudaSuccess) return err;

  ssd_bwd_chunk_tc_kernel<<<dim3(d.N / nw, d.H, d.B * d.C * 2), kTcChunkThreads, smem1,
                            stream>>>(xp, dtp, ap, bp, cp, dyp, cum_ws, states, dstates, d, st,
                                      nw);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t PN4 = (size_t)d.P * d.N / 4;
  ssd_bwd_state_tc_kernel<<<dim3((unsigned)((PN4 + kThreads - 1) / kThreads), d.H, d.B),
                            kThreads, 0, stream>>>(cum_ws, states, dstates,
                                                   static_cast<const float*>(dfinal), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int warps = (d.Q / 16) % kTcGradWarps == 0 ? kTcGradWarps : 4;
  k3<<<dim3(d.B * d.C, d.H), 32 * warps, smem3, stream>>>(
      xp, dtp, ap, bp, cp, dyp, cum_ws, states, dstates, dfinal != nullptr,
      static_cast<bf16*>(dx), static_cast<float*>(ddt), db_part, dc_part, da_part, d, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t elems = (size_t)d.B * d.S * d.N;
  ssd_bwd_reduce_kernel<bf16><<<(unsigned)((elems + kThreads - 1) / kThreads), kThreads, 0,
                                stream>>>(db_part, dc_part, static_cast<bf16*>(dB),
                                          static_cast<bf16*>(dC), d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_reduce_da_kernel<<<(d.H + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      da_part, static_cast<float*>(dA), d);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of a route's largest block, in bytes (route 0: the
// CUDA cores' gradient pass; 1: the tensor cores' chunk or gradient pass).
extern "C" size_t ssd_bwd_smem(int P, int N, int Q, int route) {
  return route == 1 ? tc_smem(P, N, Q) : sizeof(float) * grad_smem_floats(P, N, Q);
}

// Plain C entry point, bound with ctypes. dtype codes: 0 float32, 1
// bfloat16 (dy in x's type). `strides` holds 12 element strides: x (b, s,
// h), dt (b, s), Bm (b, s), Cm (b, s), dy (b, s, h). `dfinal` may be null
// (on route 1, 16-byte aligned). `workspace` holds ops._bwd_workspace_bytes.
// route: 0 the CUDA-core passes, 1 the tensor-core passes (bf16 x, dy, B
// and C with 16-byte aligned rows; P and N multiples of 16 up to 256, Q a
// multiple of 64 up to 256, within ssd_bwd_smem). Returns the first
// launch's error (cudaGetLastError(), or the error of setting a kernel's
// shared-memory limit).
extern "C" int ssd_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                       const void* Cm, const void* dy, const void* dfinal, void* dx, void* ddt,
                       void* dA, void* dB, void* dC, void* workspace, int Bsz, int S, int H,
                       int P, int N, int Q, int x_dtype, int bc_dtype, const long long* strides,
                       int route, void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 || workspace == nullptr)
    return cudaErrorInvalidValue;
  const Dims d{Bsz, S, H, P, N, Q, (S + Q - 1) / Q};
  const long long* s = strides;
  const Strides st{s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9], s[10], s[11]};
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (x_dtype != 1 || bc_dtype != 1) return cudaErrorInvalidValue;
    return launch_tc(x, dt, A, Bm, Cm, dy, dfinal, dx, ddt, dA, dB, dC, workspace, d, st, cs);
  }
  if (route != 0) return cudaErrorInvalidValue;
  switch (x_dtype) {
    case 0:
      return dispatch_bc<float>(bc_dtype, x, dt, A, Bm, Cm, dy, dfinal, dx, ddt, dA, dB, dC,
                                workspace, d, st, cs);
    case 1:
      return dispatch_bc<__nv_bfloat16>(bc_dtype, x, dt, A, Bm, Cm, dy, dfinal, dx, ddt, dA, dB,
                                        dC, workspace, d, st, cs);
    default:
      return cudaErrorInvalidValue;
  }
}
